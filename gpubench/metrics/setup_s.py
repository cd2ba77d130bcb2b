"""Process start to the window's start: imports, the CUDA context, the
kernel libraries (built on a checkout's first run), the code, the Sweep,
the warm-up and the run that sizes the window, in s."""


def read(run):
    return run.setup_s
