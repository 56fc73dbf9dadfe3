"""uvhand_tpu_torch: the PyTorch/CUDA port of `uvhand_tpu`.

The JAX package `uvhand_tpu` stays the reference; this package mirrors its
module layout so each port module sits at the same relative path as its JAX
counterpart. It imports neither JAX nor `uvhand_tpu`.

Entry points (model builders, `engine.make_eval_step`,
`engine.make_fused_train_step`, the synthetic MANO/object builders) run on
the CUDA card unless the caller passes
`device="cpu"`; without a card and without that argument they raise.
"""

__version__ = "0.1.0"
