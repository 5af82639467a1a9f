"""The ggml reference harness: the reference's own C++ stage classes, built
from $ZEROVOX_REF and run in a worker process (build.py, stage_proc.py), for
`cli --verify` (utils/verify.py) and the stage-diff tests."""
