"""The paper's experiments on the port: the mini-CNN figures (Fig. 15a/b), the
Sec. VI-D CAxCNN comparison, Table II energy, dynamic against static
activations, and the LM training and post-training-quantization scripts.

The JAX package keeps them under ``benchmarks/`` and ``examples/``; here
they live inside the package, with the same module and function names.
Each module's ``main()`` prints the JAX package's ``name,us,derived``
rows::

    python -m repro_torch.experiments.fig15a_error_comp      # on the card
    python -m repro_torch.experiments.fig15b_accuracy_pdp --device cpu
    python -m repro_torch.experiments.caxcnn_compare
    python -m repro_torch.experiments.train_lm --steps 300
"""
