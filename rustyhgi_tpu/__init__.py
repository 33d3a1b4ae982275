"""rustyhgi_tpu — a Hierarchical Grid Interpolation image codec in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
pl0q1n/RustyHGI (Gashnikov/Glumov/Sergeev 2010 hierarchical grid
interpolation compression): pyramid decimation, Crossed interpolation,
fixed-max-error linear quantization, entropy-coded container — built for
an accelerator from the start (dense lattice programs, SPMD batch
sharding over device meshes, host-side native entropy stages); it runs
on an NVIDIA GPU.

Public API::

    from rustyhgi_tpu import HGICodec, QuantizationLevel
    codec = HGICodec(levels=4, quantization="medium")
    archive = codec.encode(image_u8_hw)         # device encode + container
    blob = write_archive(archive, "hgi")        # byte-compatible .hgi
    image = codec.decode(read_archive(blob))

Interop: archives written with ``fmt="hgi"`` are byte-compatible with the
reference's container (reference: src/archive.rs:31-55) and decode to
bit-identical pixels; ``fmt="thgi"`` is the native container (best-of
DEFLATE/rANS entropy stage, never larger).
"""

from .models.codec import CodecMetrics, HGICodec
from .ops.quantizers import (
    QuantizationLevel,
    linear_error,
    linear_quantize,
    linear_table,
    quantize_fn,
)
from .utils.color import decode_color, encode_color
from .utils.container import (
    Archive,
    Interpolation,
    Metadata,
    read_archive,
    read_hgi,
    read_thgi,
    read_thgi_preview,
    write_archive,
    write_hgi,
    write_thgi,
)

__version__ = "0.1.0"

__all__ = [
    "HGICodec",
    "CodecMetrics",
    "QuantizationLevel",
    "Interpolation",
    "Archive",
    "Metadata",
    "read_archive",
    "read_hgi",
    "read_thgi",
    "read_thgi_preview",
    "encode_color",
    "decode_color",
    "write_archive",
    "write_hgi",
    "write_thgi",
    "linear_error",
    "linear_quantize",
    "linear_table",
    "quantize_fn",
    "__version__",
]
