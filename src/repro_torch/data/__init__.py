"""The deterministic synthetic token pipeline (``pipeline``)."""
