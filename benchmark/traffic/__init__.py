"""The traffic generator (``graphs.py``)."""
