"""Benchmark & verification harness (JAX analog of the reference's C++
``test.cu`` bench/check binary — SURVEY.md §2.2, §4)."""
