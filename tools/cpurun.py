"""Run a module CLI on the CPU backend with N virtual devices.

  python tools/cpurun.py [-n N] <module> [args...]

Forces the CPU platform via jax.config BEFORE any backend touch, so
pipeline CLIs can be exercised with N virtual devices without taking the
GPU from a running job (a JAX process reserves most of the card's memory).
"""
import sys
import os

n = 8
argv = sys.argv[1:]
if argv and argv[0] == "-n":
    n = int(argv[1])
    argv = argv[2:]
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + f" --xla_force_host_platform_device_count={n}").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import runpy  # noqa: E402

sys.path.insert(0, os.getcwd())   # script invocation puts tools/ first
sys.argv = argv
runpy.run_module(argv[0], run_name="__main__")
