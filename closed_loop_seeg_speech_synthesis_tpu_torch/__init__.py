"""PyTorch + CUDA port of the closed-loop sEEG speech synthesis decoder.

Sits beside the JAX package ``closed_loop_seeg_speech_synthesis_tpu``, which
stays the numerical reference.  This package imports ``torch`` and never
``jax``; its host-side design code (filter design, frame schedules,
state-space builders, mel/DFT/window constants) is carried as numpy copies
whose headers name their JAX-package counterparts, because importing any
``closed_loop_seeg_speech_synthesis_tpu.ops`` module imports jax.

Ported so far: training (``runtime.trainer.train`` and ``cli.train``), the
offline replay decode (``runtime.pipeline.offline_decode`` and the offline
mode of ``cli.decode``, with its exact-host vocoder and ``--profile``), the
online closed loop (``runtime.online`` and the online mode of
``cli.decode``) and the evaluation (``eval.exp1`` - ``eval.exp4``,
``eval.figures`` and every step of ``cli.evaluate``), with hand-written CUDA kernels for
sm_90a: ``ops.cuda_frontend`` (raw sEEG -> log-power features or logMel
frames) and ``ops.cuda_gl`` (logMel frames -> Griffin-Lim blocks or int16
audio).

Precision policy: the JAX package pins ``Precision.HIGHEST`` on every
contraction of the decode path (docs/NUMERICS.md), so TF32 is switched off
for both matmuls and cuDNN convolutions on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
