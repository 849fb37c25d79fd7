"""Metric, event and span names the trainer and the checkpoint emit (the
subset of ``dlrover_tpu/telemetry/names.py`` the port emits, with the
same values, so one dashboard reads both packages)."""

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
    # performance attribution: one record per built step (counted FLOPs
    # and bytes, exchange bytes, peak memory), keyed by the program cache
    ATTRIBUTION_CAPTURED = "attribution_captured"


class SpanName:
    STEP_DISPATCH = "step_dispatch"
    HOST_SYNC = "host_sync"
    EVALUATE = "evaluate"
    STATE_SNAPSHOT = "state_snapshot"
    CKPT_SAVE_STAGE = "ckpt_save_stage"
    CKPT_MIRROR = "ckpt_mirror"
    CKPT_RESTORE = "ckpt_restore"
    LIVE_RESHARD = "live_reshard"
