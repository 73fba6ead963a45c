"""Serving-side conversion of model parameters (stacked LM leaves to packed codes),
the train loop, the mesh layer's sharding rules, elastic mesh and counted
collectives, the straggler monitor and the deprecated ``serve_loop`` entry points."""
