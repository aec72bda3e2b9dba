"""One reader per per-layer metric, `<metric name>.py`, loaded by path
(core/registry.py); `_readers.py` holds what they share."""
