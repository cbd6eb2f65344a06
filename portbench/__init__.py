"""The benchmark of closed_loop_seeg_speech_synthesis_tpu_torch on one NVIDIA H100 (see README.md)."""
