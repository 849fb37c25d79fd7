"""Metric, event and span names the trainer, the checkpoint and the
serving worker emit or read (the subset of
``dlrover_tpu/telemetry/names.py`` the port uses, with the same values,
so one dashboard reads both packages)."""

STEP_TIME = "dlrover_step_time_seconds"
STEP_DISPATCH_TIME = "dlrover_step_dispatch_seconds"
STEP_HOST_SYNC_TIME = "dlrover_step_host_sync_seconds"
TRAIN_STEPS = "dlrover_train_steps_total"
NONFINITE_STEPS = "dlrover_nonfinite_steps_total"
NONFINITE_ROLLBACKS = "dlrover_nonfinite_rollbacks_total"
PREEMPT_NOTICES = "dlrover_preemption_notices_total"
EVAL_TIME = "dlrover_eval_seconds"
SNAPSHOT_TIME = "dlrover_state_snapshot_seconds"
CKPT_SAVES = "dlrover_checkpoint_saves_total"
CKPT_SAVE_TIME = "dlrover_checkpoint_save_stage_seconds"
CKPT_MIRROR_TIME = "dlrover_checkpoint_mirror_seconds"
CKPT_MIRROR_TIMEOUTS = "dlrover_checkpoint_mirror_timeouts_total"
CKPT_RESTORE_TIME = "dlrover_checkpoint_restore_seconds"
CKPT_RESTORES = "dlrover_checkpoint_restores_total"
# in-process world or knob changes (live reshard, retune)
LIVE_RESHARDS = "dlrover_live_reshards_total"
LIVE_RESHARD_TIME = "dlrover_live_reshard_seconds"
# ElasticTrainer's cache of built steps
PROGRAM_CACHE_HITS = "dlrover_program_cache_hits_total"
PROGRAM_CACHE_MISSES = "dlrover_program_cache_misses_total"

# data plane: the H2D prefetcher (trainer.data.DevicePreloader and the
# shm path's DevicePrefetcher)
DATA_PREFETCH_QUEUE_DEPTH = "dlrover_data_prefetch_queue_depth"
# producer wait: the pump blocked handing a ready batch to a full
# queue (consumer-slow: the healthy direction)
DATA_PRODUCER_WAIT_TIME = "dlrover_data_producer_wait_seconds"
# consumer wait: the train loop blocked on an empty prefetch queue
# (producer-slow: the input-bound direction)
DATA_CONSUMER_WAIT_TIME = "dlrover_data_consumer_wait_seconds"
# executor host time blocked fetching the next batch
INPUT_WAIT_TIME = "dlrover_input_wait_seconds"
# fraction of the last materialization window spent waiting on input
# (absent until the first measured window, never a fake 0)
INPUT_WAIT_FRAC = "dlrover_input_wait_fraction"

# performance attribution (telemetry.attribution): the per-step cost
# record of the built step fused with measured step times. Gauges are
# created only once a record was captured: absent means "not measured",
# never 0.
# live MFU: counted FLOPs/step over (measured step s x device peak)
ATTR_MFU = "dlrover_attribution_mfu"
# counted FLOPs / counted bytes: low values = bound by memory
ATTR_ARITH_INTENSITY = "dlrover_attribution_arithmetic_intensity"
# clamped (1 - ideal compute s / measured step s): an upper bound on
# the step's un-overlapped communication share
ATTR_EXPOSED_COMM_FRAC = "dlrover_attribution_exposed_comm_fraction"
# the static record, exported for scrape-side math
ATTR_FLOPS_PER_STEP = "dlrover_attribution_flops_per_step"
ATTR_PEAK_HBM_MB = "dlrover_attribution_compiled_peak_hbm_mb"
ATTR_COMM_PREDICTED_S = "dlrover_attribution_predicted_comm_seconds"
# device memory headroom: free bytes as torch.cuda.mem_get_info reads
# them (absent on the CPU, never a fake 0)
ATTR_HBM_HEADROOM_MB = "dlrover_attribution_hbm_headroom_mb"

# serving worker (serving.engine): the continuous-batching decode loop
SERVE_DECODE_STEPS = "dlrover_serve_decode_steps_total"
SERVE_TOKENS = "dlrover_serve_tokens_total"
SERVE_PREFILL_CHUNKS = "dlrover_serve_prefill_chunks_total"
SERVE_ADMISSIONS = "dlrover_serve_admissions_total"
SERVE_SLOT_OCCUPANCY = "dlrover_serve_slot_occupancy"
SERVE_STEP_TIME = "dlrover_serve_decode_step_seconds"
# admit -> first token host-visible
SERVE_PREFILL_TIME = "dlrover_serve_prefill_seconds"
# the shared prefix pool: admissions with and without a hit, pages
# evicted for a publish, prefill tokens a hit skipped, and occupancy
SERVE_PREFIX_HITS = "dlrover_serve_prefix_hits_total"
SERVE_PREFIX_MISSES = "dlrover_serve_prefix_misses_total"
SERVE_PREFIX_EVICTIONS = "dlrover_serve_prefix_evictions_total"
SERVE_PREFIX_SAVED_TOKENS = "dlrover_serve_prefix_saved_prefill_tokens_total"
SERVE_PREFIX_POOL_USED_PAGES = "dlrover_serve_prefix_pool_used_pages"
SERVE_PREFIX_POOL_BYTES = "dlrover_serve_prefix_pool_bytes"
# speculative decode: drafted = accepted + wasted; the rate gauge is -1
# until the first draft
SERVE_SPEC_VERIFY_STEPS = "dlrover_serve_spec_verify_steps_total"
SERVE_SPEC_DRAFTED = "dlrover_serve_spec_drafted_tokens_total"
SERVE_SPEC_ACCEPTED = "dlrover_serve_spec_accepted_tokens_total"
SERVE_SPEC_WASTED = "dlrover_serve_spec_wasted_tokens_total"
SERVE_SPEC_ACCEPT_RATE = "dlrover_serve_spec_accept_rate"
# live serving resizes (ServeEngine.live_resize): count and wall seconds
SERVE_RESIZES = "dlrover_serve_resizes_total"
SERVE_RESIZE_TIME = "dlrover_serve_resize_seconds"
# node runtime snapshots a worker pushed to the master, and those lost
# (serving.slo.ServeRuntimeReportHook)
NODE_RUNTIME_REPORTS = "dlrover_node_runtime_reports_total"
NODE_RUNTIME_REPORT_FAILURES = "dlrover_node_runtime_report_failures_total"


class EventKind:
    NONFINITE_STEP = "nonfinite_step"
    TRAIN_START = "train_start"
    TRAIN_END = "train_end"
    # first materialized step after TRAIN_START: its latency is the
    # set-up cost (kernel builds, allocator warm-up, a restore)
    COMPILE_FIRST_STEP = "compile_first_step"
    STATE_SNAPSHOT = "state_snapshot"
    PREEMPT_NOTICE = "preempt_notice"
    PREEMPT_DRAIN_DONE = "preempt_drain_done"
    CKPT_SAVE = "ckpt_save"
    CKPT_MIRROR = "ckpt_mirror"
    CKPT_MIRROR_TIMEOUT = "ckpt_mirror_timeout"
    CKPT_RESTORE = "ckpt_restore"
    ROLLBACK_RESTORED = "rollback_restored"
    LIVE_RESHARD_BEGIN = "live_reshard_begin"
    LIVE_RESHARD_DONE = "live_reshard_done"
    # what the failover monitor classifies (trainer/failover.py)
    RDZV_JOIN = "rdzv_join"
    SCALE_PLAN_APPLIED = "scale_plan_applied"
    WORKER_FAILED = "worker_failed"
    # a runtime-optimizer plan applied live (trainer/executor.py)
    OPTIMIZER_APPLY_DONE = "optimizer_apply_done"
    # performance attribution: one record per built step (counted FLOPs
    # and bytes, exchange bytes, peak memory), keyed by the program cache
    ATTRIBUTION_CAPTURED = "attribution_captured"
    # serving worker: the loop's start and end, a request that cannot
    # fit the pool (failure-class, carries an error code), each request's
    # prefill chunks, first token and completion, and the prefix pool's
    # hits and evictions
    SERVE_START = "serve_start"
    SERVE_END = "serve_end"
    SERVE_REQUEST_EVICTED = "serve_request_evicted"
    SERVE_PREFILL_CHUNK = "serve_prefill_chunk"
    SERVE_FIRST_TOKEN = "serve_first_token"
    SERVE_REQUEST_DONE = "serve_request_done"
    SERVE_PREFIX_HIT = "serve_prefix_hit"
    SERVE_PREFIX_EVICTED = "serve_prefix_evicted"
    # a live resize of the serving worker: its start, and its end with
    # world_from / world_to / reshard_seconds / recompiled
    SERVE_RESIZE_BEGIN = "serve_resize_begin"
    SERVE_RESIZE_DONE = "serve_resize_done"
    # the router's edges (written by the master, read by the forensic
    # ``requests --events`` view)
    SERVE_REQUEST_SUBMITTED = "serve_request_submitted"
    SERVE_REQUEST_COMPLETED = "serve_request_completed"
    SERVE_LEASE_EXPIRED = "serve_lease_expired"


class SpanName:
    STEP_DISPATCH = "step_dispatch"
    HOST_SYNC = "host_sync"
    EVALUATE = "evaluate"
    STATE_SNAPSHOT = "state_snapshot"
    CKPT_SAVE_STAGE = "ckpt_save_stage"
    CKPT_MIRROR = "ckpt_mirror"
    CKPT_RESTORE = "ckpt_restore"
    LIVE_RESHARD = "live_reshard"
    # serving: one decode (or verify) call, one prefill chunk
    SERVE_DECODE = "serve_decode_step"
    SERVE_PREFILL = "serve_prefill_chunk"
