"""Build the native pack library: ``python -m mxmoe.native.build``."""

from __future__ import annotations

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(__file__)
    src = os.path.join(here, "..", "..", "csrc", "mxmoe_pack.cpp")
    out = os.path.join(here, "libmxmoe_pack.so")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", os.path.abspath(src), "-o", out,
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from mxmoe import native

    assert native.available(), "library built but failed to load"
    print(f"built + loadable: {path}")
