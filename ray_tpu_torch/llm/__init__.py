"""LLM serving of the port: the continuous-batching engine, guided
decoding, the batch-inference stages and prefill/decode disaggregation
on Serve (``build_disagg_app``, loaded on first access: it imports
Serve, which imports this package)."""

from ray_tpu_torch.llm.engine import (
    ContinuousBatchingEngine, EngineConfig, EngineSaturatedError,
    GenerationRequest)
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer


def __getattr__(name):
    if name == "build_disagg_app":
        from ray_tpu_torch.llm.disagg import build_disagg_app
        return build_disagg_app
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ByteTokenizer", "ContinuousBatchingEngine", "EngineConfig",
           "EngineSaturatedError", "GenerationRequest", "build_disagg_app",
           "get_tokenizer"]
