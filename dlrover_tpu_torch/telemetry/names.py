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


class SpanName:
    STEP_DISPATCH = "step_dispatch"
    HOST_SYNC = "host_sync"
    EVALUATE = "evaluate"
    STATE_SNAPSHOT = "state_snapshot"
    CKPT_SAVE_STAGE = "ckpt_save_stage"
    CKPT_MIRROR = "ckpt_mirror"
    CKPT_RESTORE = "ckpt_restore"
    LIVE_RESHARD = "live_reshard"
