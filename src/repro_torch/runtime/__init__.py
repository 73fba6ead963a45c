"""Serving-side conversion of model parameters (stacked LM leaves to packed codes),
the straggler monitor and the deprecated ``serve_loop`` entry points."""
