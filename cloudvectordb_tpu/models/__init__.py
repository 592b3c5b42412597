"""L5 encoder layer: plain-JAX transformer sentence encoder + large-batch encode."""

from cloudvectordb_tpu.models.encoder import Encoder, init_encoder  # noqa: F401
