"""The dense decoder family: layers, GQA attention, prefill/decode, and the
conversion of JAX params."""
