"""Pluggable wire-format codecs of the port (see base.py)."""
from repro_torch.codecs.base import (Codec, build_codec, codec_for_level,
                                     get_codec, list_codecs, pack_bits,
                                     pack_payload, plan_wire_bytes,
                                     register_codec, unpack_bits,
                                     unpack_payload)
# importing the module runs the @register_codec decorators
from repro_torch.codecs import builtin  # noqa: F401

__all__ = ["Codec", "build_codec", "codec_for_level", "get_codec",
           "list_codecs", "pack_bits", "pack_payload", "plan_wire_bytes",
           "register_codec", "unpack_bits", "unpack_payload"]
