"""`python -m thesia_tpu_torch` launches the engine service + viewer on the
card (``--device cpu`` for the CPU)."""

from .engine.service import main

if __name__ == "__main__":
    main()
