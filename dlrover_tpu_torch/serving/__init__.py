"""The serving tier on one card (port of ``dlrover_tpu/serving``, its
single-worker core): continuous-batching decode with the same weights
and runtime that train.

Modules:
  kv_cache      paged, preallocated KV pool and its sharding rules (int8
                pages through ``ops.quantize``)
  engine        ServeEngine (serve programs, program cache, promotion of
                a trainer's snapshot or checkpoint, prewarm, retune,
                snapshot and live resize) and ServeExecutor (continuous
                batching over fixed slots, prefix reuse, speculative
                decode, the master's serve plans at a drained boundary)
  prefix_index  the host radix index of the shared prefix pool
  spec_decode   the host n-gram draft proposer
  slo           ServeRuntimeReportHook, the worker's runtime reports
  cli           ``requests --events``: the forensic request ledger

The router runs on the master (the reference's); serving over several
devices or ranks is ROADMAP A16c, the CLI's live views A12.
"""

from dlrover_tpu_torch.serving.kv_cache import (  # noqa: F401
    KVCacheSpec,
    init_kv_cache,
    kv_cache_rules,
    resolve_kv_precision,
)


def __getattr__(name):
    # the engine imports the model; keep ``import
    # dlrover_tpu_torch.serving`` light
    if name in ("ServeEngine", "ServeExecutor", "ServeRequestState"):
        from dlrover_tpu_torch.serving import engine

        return getattr(engine, name)
    raise AttributeError(name)
