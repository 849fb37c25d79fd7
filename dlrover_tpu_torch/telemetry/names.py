"""Metric, event and span names the trainer uses (the subset of
``dlrover_tpu/telemetry/names.py`` this slice emits, with the same
values, so one dashboard reads both packages)."""

STEP_TIME = "dlrover_step_time_seconds"
STEP_DISPATCH_TIME = "dlrover_step_dispatch_seconds"
STEP_HOST_SYNC_TIME = "dlrover_step_host_sync_seconds"
TRAIN_STEPS = "dlrover_train_steps_total"
NONFINITE_STEPS = "dlrover_nonfinite_steps_total"
EVAL_TIME = "dlrover_eval_seconds"


class EventKind:
    NONFINITE_STEP = "nonfinite_step"
    TRAIN_START = "train_start"
    TRAIN_END = "train_end"
    # first materialized step after TRAIN_START: its latency is the
    # set-up cost (kernel builds, allocator warm-up)
    COMPILE_FIRST_STEP = "compile_first_step"


class SpanName:
    STEP_DISPATCH = "step_dispatch"
    HOST_SYNC = "host_sync"
    EVALUATE = "evaluate"
