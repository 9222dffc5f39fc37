"""PyTorch / CUDA port of fudanocr_tpu, first slice: TBSRN -> CRNN serving.

The subpackages mirror `fudanocr_tpu/` module by module, so each port
module sits where its JAX counterpart does. The JAX package is the
reference the port is checked against (tests/test_torch_*.py); this
package imports torch and never jax, flax or PIL.

Conventions shared by every module here:
  * public image tensors are NHWC, as in the JAX package; convolutions run
    NCHW inside;
  * parameters stay float32 and each model takes a compute `dtype`
    (float32 or bfloat16) that activations and weights are cast to, the
    way flax's `dtype=` works, so both packages round at the same places;
  * module attribute names follow the original FudanOCR state_dict keys
    that `fudanocr_tpu.utils.torch_port` reads, so JAX weights move in
    through `utils.weights.load_jax_variables` and reference .pth files
    load with `load_state_dict`.
"""
