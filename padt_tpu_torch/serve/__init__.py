"""Continuous-batching serving (slot-recycled decode pool) on PyTorch."""

from .engine import (  # noqa: F401
    Completion,
    DecodeState,
    PrefillPack,
    Request,
    ServeEngine,
    ServeStats,
    SharedPrefix,
    decode_chunk,
    decode_chunk_spec,
    init_state,
    insert,
    prefill,
)
