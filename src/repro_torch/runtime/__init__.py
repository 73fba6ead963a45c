"""Serving-side conversion of model parameters (stacked LM leaves to packed codes)."""
