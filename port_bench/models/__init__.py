"""The port's side of each model, one module each (``models/<model>.py``)."""
