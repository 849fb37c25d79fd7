"""dlrover_tpu_torch — the PyTorch/CUDA port of ``dlrover_tpu``.

It mirrors the JAX package's layout (``ops/``, ``models/``,
``parallel/``, ``trainer/``, ``common/``, ``telemetry/``,
``checkpoint/``, ``utils/``) so each module
has one counterpart there, imports nothing of it (nor JAX), and runs
its attention through hand-written Hopper kernels (``csrc/``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
