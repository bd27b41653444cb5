"""setup_s: from the process's start to the window's opening: imports,
weights made on the device, the kernel library's load (its nvcc build in a
checkout's first run), the pipeline's preparation, and one group of the
cell's own signature (the loop's eager run and capture, CLIP, the decode)."""


def read(run, name):
    return run.setup_s
