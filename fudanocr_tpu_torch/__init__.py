"""PyTorch / CUDA port of fudanocr_tpu: TBSRN -> CRNN serving, TBSRN
text-focus training, CascadeMiT text-segmentation inference.

The subpackages mirror `fudanocr_tpu/` module by module, so each port
module sits where its JAX counterpart does. The JAX package is the
reference the port is checked against (tests/test_torch_*.py); this
package imports torch and nothing of jax, flax, PIL or `fudanocr_tpu`.

Conventions shared by every module here:
  * public image tensors are NHWC, as in the JAX package; convolutions run
    NCHW inside;
  * parameters stay float32 and each model takes a compute `dtype`
    (float32 or bfloat16) that activations and weights are cast to, the
    way flax's `dtype=` works, so both packages round at the same places
    (the segmentation models run float32 only, for now);
  * module attribute names follow the original FudanOCR state_dict keys
    that the porters (`utils/porters.py`, a copy of the JAX package's)
    read, so JAX weights move in through `utils.weights.load_jax_variables`
    and reference .pth files load with `load_state_dict`;
  * entry points run on the card (`device="cuda"`) unless the caller asks
    for the CPU.
"""
