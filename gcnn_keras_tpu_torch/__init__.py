"""PyTorch/CUDA port of ``gcnn_keras_tpu``, laid out module for module like it.

The JAX package stays the reference; each module here names its counterpart.
Entry points (``batch_graphs``, ``make_model``, ``EnergyForceModel``,
``MolDynamicsModelPredictor``, ``GraphBatchLoader``, ``run_force_training``
and the training scripts of ``scripts/``) run on CUDA unless the caller
passes ``device="cpu"``. Hand-written kernels live in ``csrc/`` and are built with
``nvcc`` on first use (``ops/cuda/build.py``).
"""
