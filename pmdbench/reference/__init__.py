"""Plain reference of what the benchmark's timed path produces, in plain
PyTorch: the movie statistics (``stats``), the temporal regression on a
decomposition's spatial basis (``projection``), the frames a
decomposition serves (``frames``) and the share of each of the movie's
sources that the spatial basis leaves out (``sources``). Imports torch and
numpy only: no part of the program under test, and nothing the program
made but the outputs it judges."""
