"""Verbose: leveled logger (System.h:41-66 equivalent).

The port's own copy of movslam_tpu/core/verbose.py; its level is its own."""
from __future__ import annotations


class Verbose:
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4

    level = DEBUG  # the C++ reference defaults to DEBUG (System.cc:37)

    @classmethod
    def log(cls, msg, level=NORMAL):
        if level <= cls.level:
            print(msg, flush=True)
