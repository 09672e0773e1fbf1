"""mxnet_tpu_torch.serving — the port's serving runtime over ``.mxa``
artifacts (counterpart of mxnet_tpu/serving): the fourth pillar (train /
export / predict / **serve**).

    engine.ServingEngine   one plan at the export batch over a
                           Predictor (a request's rows in, the rest
                           zeroed on the device, outputs sliced back;
                           warmup; the bucket ladder in stats): one CUDA
                           graph on the card.
    batcher.DynamicBatcher micro-batches concurrent requests up to
                           max_batch / max_wait_us over a bounded queue,
                           with per-request deadlines and load shedding.
    metrics.ServingMetrics QPS / p50 / p99 / batch histogram / queue
                           depth / shed count (per admission class).
    pool.EnginePool        R engine replicas (own graphs, own CUDA
                           stream) behind least-loaded dispatch.
    router.ModelRouter     many hot models in one process: admission
                           within the card's memory budget + LRU eviction
                           by measured plan_resident_bytes.
    frontend.ServingFrontend
                           stdlib HTTP/1.1 JSON front door
                           (predict/load/unload/generate//metrics) over a
                           ModelRouter.
    decode.DecodeEngine    autoregressive decode: per-session KV-cache
                           pool, prefill buckets, one decode-step graph
                           continuous-batching every live session.

Everything runs on the card unless ``device="cpu"`` is given.

    from mxnet_tpu_torch import serving
    eng = serving.ServingEngine("model.mxa")          # builds its plan
    with serving.DynamicBatcher(eng, max_wait_us=2000,
                                queue_depth=256) as bat:
        out = bat.infer(x_row)                        # from any thread

CLI: ``python -m mxnet_tpu_torch.serving --selftest`` (closed-loop load
against the batcher, one JSON line) and ``python -m
mxnet_tpu_torch.serving.frontend --selftest`` (the network tier through
real sockets).
"""
from .batcher import (ADMISSION_CLASSES, DynamicBatcher, Future,
                      RequestTimeout, ServingQueueFull)
from .decode import (DecodeEngine, DecodeModel, Session, SessionPool,
                     SessionPoolFull, prompt_buckets)
from .engine import ServingEngine
from .metrics import ServingMetrics
from .pool import EnginePool
from .router import ModelRouter, UnknownModel


def __getattr__(name):
    # lazy: `python -m mxnet_tpu_torch.serving.frontend` would otherwise
    # find the submodule in sys.modules before runpy executes it
    if name == "ServingFrontend":
        from .frontend import ServingFrontend
        return ServingFrontend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ADMISSION_CLASSES", "DecodeEngine", "DecodeModel",
           "DynamicBatcher", "EnginePool", "Future", "ModelRouter",
           "RequestTimeout", "ServingEngine", "ServingFrontend",
           "ServingMetrics", "ServingQueueFull", "Session", "SessionPool",
           "SessionPoolFull", "UnknownModel", "prompt_buckets"]
