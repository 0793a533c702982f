"""Per-layer metric readers, one module each (``metrics/<metric>.py``:
``read(ctx)``), and the work and peak functions they share (``_work.py``)."""
