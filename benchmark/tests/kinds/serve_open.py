"""Kind ``serve_open``: its tiny sizes and its planted faults."""

from benchmark.tests.kinds.serving import FAULTS, SERVE  # noqa: F401

TINY = {**SERVE, "traffic": {"rate": 60, "profile_s": 0.5}}
