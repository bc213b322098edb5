"""HTTP serving of the port's pipeline (``server.py``) and its demo page."""
