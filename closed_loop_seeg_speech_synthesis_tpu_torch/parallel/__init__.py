"""Several ranks: the (data, model) mesh over a ``torch.distributed``
process group, the channel-sharded decode, replay and training batched over
sessions (``mesh``, ``sharded``), and the multi-process entry points and
dryruns (``distributed``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/parallel/``.  Submodules are
imported by their users; importing this package loads none of them."""
