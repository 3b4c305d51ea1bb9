"""setup_s: seconds from the process's start to the window's start
(imports, CUDA, the inputs, the program's graph and route build, the
warm-up call), host clock."""


def read(run):
    return run.setup_s
