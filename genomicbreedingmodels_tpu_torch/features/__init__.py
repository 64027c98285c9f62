"""Epistasis feature engineering: the endofunctions on [0, 1]
(`endofunctions.py`) and the transforms that rank engineered features by
their single-feature effect (`transform.py`)."""
