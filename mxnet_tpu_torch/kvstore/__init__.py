"""Host-side wire of the port (framing and payload codecs)."""
from .wire_codec import (WireCodecError, decode_array, decode_json,
                         decode_text, encode_array, encode_json, encode_text,
                         recv_msg, send_msg)

__all__ = ["WireCodecError", "decode_array", "decode_json", "decode_text",
           "encode_array", "encode_json", "encode_text", "recv_msg",
           "send_msg"]
