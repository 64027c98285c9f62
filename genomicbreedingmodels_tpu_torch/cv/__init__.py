"""Cross-validation: the job harness (`harness.py`) and the batched engine (`batched.py`)."""
