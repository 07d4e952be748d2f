"""Encode/decode orchestration + pack container, and the weight
quantize/pack pipeline (port of ``nvfpcc_tpu.codec``)."""

from nvfpcc_tpu_torch.codec.codec import (  # noqa: F401
    PACK_FORMAT_VERSION,
    EncodeResult,
    decode,
    decode_latent_pack,
    decode_origins,
    decoder_from_tree,
    encode,
    encode_origins,
    extract_points,
    load_pack,
    model_spec,
    reconstruct_all,
    reconstruct_points,
    save_pack,
)
from nvfpcc_tpu_torch.codec.weights import (  # noqa: F401
    check_quantized,
    pack_weights,
    quantize_residuals,
    unpack_weights,
    weight_pack_bits,
)
