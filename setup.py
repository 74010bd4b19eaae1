from setuptools import find_packages, setup

setup(
    name="localmd_tpu",
    version="0.3.0",
    description="TPU-native localized Penalized Matrix Decomposition for functional imaging",
    packages=find_packages(exclude=("tests",)),
    package_data={"localmd_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "scipy",
        "jax",
        "jaxlib",
    ],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "localmd-tpu = localmd_tpu.cli:main",
            "localmd-tpu-torch = localmd_tpu_torch.cli:main",
        ],
    },
)
