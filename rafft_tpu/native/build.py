"""Build the native Turner evaluator shared library from source.

The library is not committed: the first use on a machine builds it here
(rafft_tpu.native._load), tuned for that machine's CPU.

Usage: python rafft_tpu/native/build.py [--force]
"""

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "turner_eval.cpp")
LIB = os.path.join(HERE, "libturner.so")


def build(force=False) -> str:
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC)):
        return LIB
    # build beside the target, then rename: processes that start at once
    # (a refold pool) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=HERE)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp, SRC], check=True)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
