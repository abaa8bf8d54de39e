"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, the kernels' library (built in the first run of a checkout,
loaded after), the seeded weights and inputs, and the warm-up of the cell's
shapes."""


def read(obs):
    return obs.setup_s
