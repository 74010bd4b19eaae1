"""Host ms inside the CUDA runtime's kernel launches during the traced
process's first ``localmd_decomposition`` call: a kernel's first launch
loads its module."""


def read(run):
    prof = run.get("first_profile")
    if not prof:
        return None
    ms = [sec for name, (_, sec) in prof["runtime"].items()
          if name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    return 1e3 * sum(ms) if ms else None
