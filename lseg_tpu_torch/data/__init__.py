"""Data loading of the port. The datasets themselves are the reference's
JAX-free modules (`lseg_tpu.data.ade20k`, `.synthetic`, ...)."""
