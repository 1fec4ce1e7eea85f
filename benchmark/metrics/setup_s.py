"""setup_s: seconds from the process's start to the window's first call:
import, inputs, the program's scene and acceleration build, the sky's
tables and the cell's warm-up calls (a checkout's first run also builds
the CUDA and native libraries)."""


def read(rec):
    return rec["setup_s"]
