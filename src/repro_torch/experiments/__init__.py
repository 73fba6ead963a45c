"""The paper's mini-CNN experiments on the port: Fig. 15(a) and Fig. 15(b).

The JAX package keeps them under ``benchmarks/``; here they live inside
the package, with the same module and function names. Each module's
``main()`` prints the JAX package's ``name,us,derived`` rows::

    python -m repro_torch.experiments.fig15a_error_comp      # on the card
    python -m repro_torch.experiments.fig15b_accuracy_pdp --device cpu
"""
