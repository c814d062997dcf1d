"""Each driver kind's test files: ``<kind>.py`` holds its ``TINY`` sizes
and its planted ``FAULTS``, found by the kind's name."""
