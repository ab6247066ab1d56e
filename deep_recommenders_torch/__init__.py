"""deep_recommenders_torch: the PyTorch and CUDA port of deep_recommenders_tpu.

The JAX package stays beside it as the reference. Module paths and names
mirror the JAX package's, so each counterpart is found under the same name.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/`` with its plain PyTorch version beside it.
"""

__version__ = "0.1.0"
