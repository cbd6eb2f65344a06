"""Online closed-loop decoding: the host event loop around the step.

Port of ``closed_loop_seeg_speech_synthesis_tpu/runtime/online.py``
(``PacketRebuffer``, ``_pump_stream``, ``OnlineDecoder``,
``PersistentOnlineDecoder``, ``read_markers``).
A stream inlet is re-blocked into fixed ``packet_size`` packets; each packet
is moved to the decoder's device once and decoded by one run of
``pipeline.make_online_step`` over static buffers (on the card one replay of
that run recorded as a CUDA graph); decoded spectrogram frames and int16
audio chunks come back to the host, and the audio goes to the sink through
the bounded-drop queue.  Per-packet latency is traced for the closed loop's
p99 < 10 ms budget (``StageTracer`` marks), and the host's parts of a
packet are spans in the profiler's trace (``seeg.online.*``).
``PersistentOnlineDecoder`` decodes a whole session as one device dispatch:
on the card, one launch of a CUDA graph whose device-side while loop runs
the step once per packet.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading

import numpy as np
import torch

from ..ops import cuda_loop
from ..ops.prng import is_key
from . import pipeline
from .audio import BufferSink
from .streams import StreamInlet
from .tracing import StageTracer, span

logger = logging.getLogger("runtime.online")


class PacketRebuffer:
    """Accumulates arbitrary inlet chunks into exact packet_size packets
    (the amplifier nominally sends whole packets; LSL may split/merge)."""

    def __init__(self, packet_size: int, n_channels: int):
        self.packet_size = packet_size
        # preallocated: no per-chunk np.concatenate on the 10 ms hot path
        self._buf = np.zeros((max(8 * packet_size, 1024), n_channels), np.float32)
        self._n = 0

    def push(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float32)
        if chunk.size:
            need = self._n + len(chunk)
            if need > len(self._buf):  # oversized burst: grow once, stays rare
                grown = np.zeros((max(2 * len(self._buf), need), self._buf.shape[1]),
                                 np.float32)
                grown[: self._n] = self._buf[: self._n]
                self._buf = grown
            self._buf[self._n : need] = chunk
            self._n = need
        out = []
        ps = self.packet_size
        k = 0
        while self._n - k >= ps:
            out.append(self._buf[k : k + ps].copy())
            k += ps
        if k:
            rem = self._n - k
            if rem:
                self._buf[:rem] = self._buf[k : self._n]
            self._n = rem
        return out


def _pump_stream(inlet: StreamInlet, rebuf: PacketRebuffer, packet_size: int,
                 on_packet, stop_event, max_packets, store_first_timestamp_to,
                 idle_timeout: float) -> int:
    """Shared inlet loop of both online decoders: pull chunks, re-block into
    packets, invoke ``on_packet`` per packet.  The ``max_packets`` cutoff is
    chunk-granular (the whole rebuffered chunk is processed before checking)
    so both dispatch modes decode identical packet sets from the same stream.
    Returns (packet count, why it stopped: "stopped", "max_packets",
    "closed" or "idle")."""
    first_ts = None
    idle = 0.0
    n = 0
    while not (stop_event and stop_event.is_set()):
        try:
            chunk, ts = inlet.pull_chunk(max_samples=max(packet_size, 64), timeout=0.25)
        except ConnectionError:
            # stream producer went away (amplifier restart): stop cleanly
            # with everything decoded so far (lsl_socket.py:44-49 policy)
            logger.warning("stream closed; stopping decode with %d packets", n)
            return n, "closed"
        if chunk.shape[0] == 0:
            idle += 0.25
            if max_packets is not None and idle > idle_timeout:
                return n, "idle"
            continue
        idle = 0.0
        if first_ts is None and ts:
            first_ts = ts
            if store_first_timestamp_to:
                np.save(store_first_timestamp_to, np.asarray(first_ts))
        for packet in rebuf.push(chunk):
            on_packet(packet)
            n += 1
        if max_packets is not None and n >= max_packets:
            return n, "max_packets"
    return n, "stopped"


def _check_complete(inlet, stream, n: int, why: str, max_packets) -> None:
    """With ``max_packets``, a stream that closed or idled before that many
    packets arrived raises: a sender that cut the stream short, or dropped
    this subscriber for reading too slowly, is never a complete decode."""
    if max_packets is not None and why in ("closed", "idle"):
        raise RuntimeError(f"stream {getattr(inlet, 'name', stream)!r} ended after {n} of "
                           f"{max_packets} packets ({why}): the sender stopped or dropped "
                           "this decoder")


class _Lane:
    """The host side of one of the decoder's programs (a
    ``pipeline.StaticStep``, on the card its ``CapturedStep``): staging
    buffers that packets are written into, host slots that its outputs are
    copied back into and, on the card, an event after each slot's copy; one
    set, or two with ``pipelined`` so that a packet's write and run never
    touch the buffers of the outputs still pending.  On the card the
    buffers are pinned, so both copies are asynchronous."""

    def __init__(self, program, n_buffers: int, on_card: bool):
        self.program = program
        self.stage = [torch.empty(program.packet.shape, dtype=program.packet.dtype,
                                  pin_memory=on_card) for _ in range(n_buffers)]
        self.slots = [program.host_slot(on_card) for _ in range(n_buffers)]
        self.events = [torch.cuda.Event() if on_card else None for _ in range(n_buffers)]
        self.turn = 0   # the buffer set the next run uses
        self.runs = 0   # runs of the program (graph replays on the card), warmup's not counted

    def launch(self):
        """Run the program on the packet(s) in the current staging buffer and
        copy its outputs into the current slot; returns (the slot's views,
        its event) and moves on to the next buffer set."""
        b, prog = self.turn, self.program
        prog.packet.copy_(self.stage[b], non_blocking=True)
        prog.run()
        slot, views = self.slots[b]
        slot.copy_(prog.flat, non_blocking=True)
        if self.events[b] is not None:
            self.events[b].record()
        self.runs += 1
        self.turn = (b + 1) % len(self.stage)
        return views, self.events[b]


class OnlineDecoder:
    """Per-packet decoding on the params' device.

    Each packet is written into a staging buffer, copied to the device once
    and decoded by one run of the step over static buffers
    (``pipeline.static_online_step``: the step of ``pipeline.make_online_step``,
    the masked commit of its new carry into the decoder's static carry, the
    copies of its outputs); the outputs come back to the host with one copy,
    and the audio goes to the sink.  On the card ``warmup()`` records that
    run as a CUDA graph (``pipeline.capture_online_step``), so a packet is
    one graph replay between two asynchronous copies, as the JAX decoder's
    packet is one call of its jitted step; on the CPU the same function runs
    eagerly.  A CUDA decoder whose recording or replay fails raises: it
    never decodes on the eager step.

    ``pipelined=True`` emits each packet's outputs when the NEXT packet
    arrives, so the device computes while the host waits for the amplifier;
    it costs one packet period of playout latency.  The staging buffers and
    host slots are doubled, so a packet never overwrites a slot whose
    outputs are still pending.

    ``chunk_steps=K`` (K > 1) buffers K packets and decodes them with one
    run of a K-step program (K calls of the same step function, outputs
    stacked on a leading K axis as ``pipeline.make_online_multi_step``
    stacks them, so the output is bit-identical to K = 1): one graph replay
    per K packets on the card.  It costs (K-1) packet periods of playout
    latency.  Composes with ``pipelined``.  The stream tail (< K packets at
    stop) drains through the single-step program, which shares the K-step's
    static carry (and, on the card, its graphs' memory pool).

    ``carry`` is the static carry: the decoder keeps its tensors for its
    whole life (``reset()`` and ``warmup()`` rewrite them in place).

    ``rand_source`` is the step's: an int seed (``PRNGKey(seed)``; 0, the
    JAX decoder's default key ``PRNGKey(0)``), a key pair, or a table of
    block inits indexed by global block index.  A table must cover every
    block the stream emits: the decoder raises before it would emit audio
    of a block past the table's end."""

    def __init__(self, cfg: pipeline.DecoderConfig, dec_params, bad_channels=(),
                 rand_source=0, sink=None, tracer=None, pipelined: bool = False,
                 chunk_steps: int = 1):
        self.cfg = cfg
        self.params = dec_params
        self.device = dec_params.device
        self.bad_channels = np.asarray(bad_channels, int)
        self.sink = sink or BufferSink()
        self.tracer = tracer or StageTracer()
        self.step = pipeline.make_online_step(dec_params, cfg, rand_source)
        self.n_rand_rows = None if is_key(rand_source) else len(rand_source)
        self.carry = pipeline.init_online_carry(dec_params, cfg)
        self.pipelined = pipelined
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        self._lanes = {}       # chunk size -> _Lane; built by warmup
        self._staged = 0       # packets staged toward the next K-chunk
        self._pending = None   # (views, event) of the last run's outputs, not yet emitted
        self.spec_frames = []
        self.audio_chunks = []
        self.received = []
        self._warm = False

    @property
    def programs(self) -> dict:
        """chunk size -> the program that decodes it (after warmup)."""
        return {k: lane.program for k, lane in self._lanes.items()}

    @property
    def replays(self) -> dict:
        """chunk size -> runs of its program since warmup (graph replays on
        the card)."""
        return {k: lane.runs for k, lane in self._lanes.items()}

    def _select(self, packet: np.ndarray) -> np.ndarray:
        if len(self.bad_channels):
            return np.delete(packet, self.bad_channels, axis=1)
        return packet

    def _to_device(self, packets) -> torch.Tensor:
        return torch.as_tensor(np.asarray(packets)).to(device=self.device, dtype=self.cfg.dtype)

    def _restore_carry(self):
        """Rewrite the static carry in place with ``init_online_carry``'s
        values: recorded graphs hold its addresses."""
        fresh = pipeline.init_online_carry(self.params, self.cfg)
        for field in dataclasses.fields(pipeline.OnlineCarry):
            getattr(self.carry, field.name).copy_(getattr(fresh, field.name))

    def warmup(self):
        """Build the programs outside the realtime path (the single step and,
        with ``chunk_steps`` K > 1, the K-step, both over the static carry;
        on the card each recorded as a CUDA graph in one memory pool), run
        each once on zeros, then restore the carry in place: warmup must not
        advance state."""
        on_card = self.device.type == "cuda"
        if not self._lanes:
            pool = None
            for k in sorted({1, self.chunk_steps}):
                if on_card:
                    prog = pipeline.capture_online_step(self.params, self.cfg, step=self.step,
                                                        chunk_steps=k, carry=self.carry, pool=pool)
                    pool = prog.graph.pool()
                else:
                    prog = pipeline.static_online_step(self.params, self.cfg, self.step, k,
                                                       carry=self.carry)
                n = 2 if self.pipelined and k == self.chunk_steps else 1
                self._lanes[k] = _Lane(prog, n, on_card)
        for lane in self._lanes.values():
            lane.program.packet.zero_()
            lane.program.is_data.fill_(1)
            lane.program.run()
        if on_card:
            torch.cuda.synchronize(self.device)
        self._restore_carry()
        self._warm = True

    def reset(self):
        """Reset all streaming state: the equivalent of the reference's
        cross-process ``FrameBuffer.reset_buffer()`` flag for feeder restarts
        (FrameBuffer.py:52-57).  The static carry is restored in place."""
        self._restore_carry()
        self._pending = None
        self._staged = 0
        for lane in self._lanes.values():
            lane.turn = 0
        self.spec_frames, self.audio_chunks, self.received = [], [], []

    def _launch(self, lane: _Lane):
        """One run of the lane's program (``seeg.online.dispatch``: the H2D
        copy, the run or graph replay, the D2H copy and the event record);
        marks ``launched``."""
        with span("seeg.online.dispatch"):
            out = lane.launch()
        self.tracer.mark("launched")
        return out

    def _emit(self, out, event=None):
        """Read step outputs (single or K-stacked) back to the host and hand
        the audio to the sink.  ``out`` holds the outputs on the device or,
        from a run, the views of its host slot; ``event`` is the slot's copy,
        waited for first (``seeg.online.wait``).  Leading axes beyond the
        slot axis are flattened: steps are in order and slots are in order
        within a step, so the valid rows in sequence are the decoded stream.
        The rows are copied out of the slot, which the next runs overwrite
        (with the valid rows and the sink, ``seeg.online.emit``)."""
        if event is not None:
            with span("seeg.online.wait"):
                event.synchronize()
        with span("seeg.online.emit"):
            spec = out["spec"].cpu().numpy().copy()
            sv = out["spec_valid"].cpu().numpy().reshape(-1)
            spec = spec.reshape(-1, spec.shape[-1])
            audio = out["audio"].cpu().numpy().copy()
            av = out["audio_valid"].cpu().numpy().reshape(-1)
            audio = audio.reshape(-1, audio.shape[-1])
            self.tracer.mark("step_done")
            self._emit_rows(spec, sv, audio, av)

    def _emit_rows(self, spec, sv, audio, av):
        """Append the valid rows of one step's host outputs and write the
        audio to the sink, after the init-table check."""
        n_blocks = len(self.audio_chunks) + int(av.sum())
        if self.n_rand_rows is not None and n_blocks > self.n_rand_rows:
            raise ValueError(f"the Griffin-Lim init table has {self.n_rand_rows} rows; "
                             f"the stream has reached block {n_blocks - 1}")
        for i in np.nonzero(sv)[0]:
            self.spec_frames.append(spec[i])
        for i in np.nonzero(av)[0]:
            self.audio_chunks.append(audio[i])
            self.sink.write(audio[i])
        self.tracer.mark("audio_out")

    def _dispatch(self, lane: _Lane):
        out = self._launch(lane)
        if self.pipelined:
            # emit the PREVIOUS outputs, computed while this packet arrived;
            # leave these in flight
            prev, self._pending = self._pending, out
            if prev is not None:
                self._emit(*prev)
        else:
            self._emit(*out)

    def process_packet(self, packet: np.ndarray):
        """One fixed-size raw packet (packet_size, all_channels) -> outputs."""
        if not self._warm:
            self.warmup()
        self.received.append(packet)
        lane = self._lanes[self.chunk_steps]
        stage = lane.stage[lane.turn].numpy()
        if self.chunk_steps > 1:
            stage[self._staged] = self._select(packet)
            self._staged += 1
            if self._staged < self.chunk_steps:
                return
            self._staged = 0
        else:
            stage[...] = self._select(packet)
        self.tracer.mark("packet_in")
        self._dispatch(lane)

    def flush(self):
        """Drain the pipelined/chunked tail (call at stream end): the pending
        outputs, then the packets short of a full K-chunk, one single step
        each."""
        if self._pending is not None:
            out, self._pending = self._pending, None
            self._emit(*out)
        if self._staged:
            chunk = self._lanes[self.chunk_steps]
            one = self._lanes[1]
            for row in chunk.stage[chunk.turn].numpy()[: self._staged]:
                one.stage[one.turn].numpy()[...] = row
                self.tracer.mark("packet_in")
                self._emit(*self._launch(one))
            self._staged = 0

    def run_stream(self, stream, stop_event: threading.Event | None = None,
                   max_packets: int | None = None, store_first_timestamp_to: str | None = None,
                   backend=None, idle_timeout: float = 30.0):
        """Pull from a live stream until stopped (decode.py:99-149).

        ``stream``: a StreamInlet or a stream name to resolve.  The step is
        warmed up before a named stream is subscribed to.  With
        ``max_packets``, a stream that closes or stays idle before that many
        packets arrived raises RuntimeError: a sender that cut the stream
        short, or dropped this subscriber for reading too slowly, is never
        returned as a complete decode."""
        if not self._warm:
            self.warmup()
        inlet = StreamInlet(stream, backend=backend) if isinstance(stream, str) else stream
        rebuf = PacketRebuffer(self.cfg.packet_size, inlet.channels)
        n, why = _pump_stream(inlet, rebuf, self.cfg.packet_size, self.process_packet,
                              stop_event, max_packets, store_first_timestamp_to, idle_timeout)
        _check_complete(inlet, stream, n, why, max_packets)
        return self.results()

    def results(self):
        self.flush()
        spectrogram = np.asarray(self.spec_frames) if self.spec_frames else np.zeros((0, self.cfg.n_mel))
        audio = np.concatenate(self.audio_chunks) if self.audio_chunks else np.zeros(0, np.int16)
        received = np.vstack(self.received) if self.received else np.zeros((0, 0))
        return spectrogram, audio, received

    def latency_report(self) -> dict:
        """Log and return the percentiles (s) of each interval between the
        stage marks, ``packet_in`` -> ``launched`` -> ``step_done`` ->
        ``audio_out``, and of the whole, ``packet_in`` -> ``audio_out``
        (the persistent decoder has no ``launched``: its report leaves out
        the intervals through it).  Keys are ``"<start>-><end>"``."""
        marked = [s for s in ("packet_in", "launched", "step_done", "audio_out")
                  if self.tracer.events.get(s)]
        pairs = list(zip(marked, marked[1:]))
        if len(pairs) > 1:
            pairs.append((marked[0], marked[-1]))
        report = {}
        for a, b in pairs:
            p = report[f"{a}->{b}"] = self.tracer.percentiles(a, b)
            logger.info("per-packet %s->%s: p50=%.3fms p95=%.3fms p99=%.3fms",
                        a, b, p[50] * 1e3, p[95] * 1e3, p[99] * 1e3)
        return report


class PersistentOnlineDecoder(OnlineDecoder):
    """Whole-session decoding as ONE device dispatch (the JAX package's
    ``PersistentOnlineDecoder``).

    On the card, warmup records the online step as a CUDA graph
    (``pipeline.capture_online_step``) and ``ops.cuda_loop.PersistentLoop``
    puts it inside a device-side while loop: a session is one graph launch
    that runs the step once per packet until it takes a STOP packet.
    Packets enter and outputs leave through rings in mapped pinned host
    memory, so the host touches the loop only at those two edges: a pump
    thread moves fed packets from the host queue into free ring slots in
    order (marking ``packet_in``), and ``run_until_stopped`` emits each
    output as its done word appears (``step_done``, the init-table check,
    the valid rows, the sink, ``audio_out``).  The step still runs on the
    STOP packet; the masked commit (``pipeline.commit_carry``) keeps the
    carry.  Outputs are bit-identical to ``OnlineDecoder``'s: the loop body
    is the same step function.

    On the CPU the same body runs as a host loop (pull from the queue, step,
    masked commit, emit): the plain version of the loop.  A CUDA decoder
    never takes it.

    Feed with ``feed_packet`` / ``feed_stop`` (from another thread, or the
    whole session beforehand: the queue is unbounded by default) and run
    with ``run_until_stopped``, or use ``run_stream``.  Sessions resume:
    each ``run_until_stopped`` continues from the carried state.  Any error
    in the pump, the emitter or the feeder, and KeyboardInterrupt, sets the
    loop's abort word; the loop ends at its next wait, its stream is waited
    for and the error is raised, so no session leaves a kernel spinning.  If
    packets were then in flight (the carry took a packet whose outputs were
    not emitted, or a packet written into the ring was never taken), the
    next session raises until ``reset()``."""

    _STOP = cuda_loop.STOP
    _DATA = cuda_loop.DATA
    _POLL_S = 0.05  # how often a waiting host thread looks for errors and stop requests

    def __init__(self, cfg: pipeline.DecoderConfig, dec_params, bad_channels=(),
                 rand_source=0, sink=None, tracer=None, queue_size: int = 0):
        super().__init__(cfg, dec_params, bad_channels=bad_channels, rand_source=rand_source,
                         sink=sink, tracer=tracer)
        self._queue = queue.Queue(maxsize=queue_size)
        # serializes warmup and reset; feeders never need it, because the
        # queue is never swapped (warmup writes its STOP packet straight
        # into the ring, where the JAX class swaps in a private queue)
        self._queue_lock = threading.Lock()
        self._captured = None   # pipeline.CapturedStep, on the card after warmup
        self._loop = None       # cuda_loop.PersistentLoop around it
        self._seq = 0           # packets written into the ring, over every session
        self._stale = False     # a session was aborted with packets in flight

    # -- feeding -----------------------------------------------------------
    def feed_packet(self, packet: np.ndarray):
        """Enqueue one fixed-size raw packet (packet_size, all_channels)."""
        self.received.append(packet)
        self._queue.put((self._select(packet), self._DATA))

    def feed_stop(self):
        self._queue.put((np.zeros((self.cfg.packet_size, self.cfg.n_channels), np.float32),
                         self._STOP))

    def process_packet(self, packet: np.ndarray):
        raise NotImplementedError(
            "PersistentOnlineDecoder decodes inside one device dispatch: use "
            "feed_packet()/feed_stop() + run_until_stopped() (or run_stream).")

    # -- running -----------------------------------------------------------
    def warmup(self):
        """Build the loop outside the real-time path and run one stop-only
        session.  On the card: record the step, build and instantiate the
        loop's graph, and write a STOP packet straight into the ring (past
        the queue).  On the CPU: one step on a STOP packet.  Queued packets
        stay queued, nothing is emitted, and the masked commit leaves the
        carry as it was.  ``feed_packet`` / ``feed_stop`` may run meanwhile:
        their packets wait in the queue for the next session."""
        P, C = self.cfg.packet_size, self.cfg.n_channels
        stop = np.zeros((P, C), np.float32)
        with self._queue_lock:
            if self.device.type == "cpu":
                new, _ = self.step(self.carry, self._to_device(stop))
                pipeline.commit_carry(self.carry, new, torch.tensor(False))
            else:
                if self._loop is None:
                    self._captured = pipeline.capture_online_step(self.params, self.cfg,
                                                                  step=self.step)
                    self.carry = self._captured.carry
                    cap = self._captured
                    self._loop = cuda_loop.PersistentLoop(
                        cap.graph.raw_cuda_graph(), cap.packet, cap.is_data,
                        [cap.outputs[k] for k in ("spec", "spec_valid", "audio", "audio_valid")])
                self._session(lambda loop, halt: self._publish(loop, stop, self._STOP, halt),
                              emit=False)
        self._warm = True

    def run_until_stopped(self):
        """Run one session: decode the queued (and still arriving) packets
        until a STOP packet; returns ``results()``.  Call ``feed_packet`` /
        ``feed_stop`` from another thread, or enqueue everything beforehand."""
        self._check_not_stale()
        if not self._warm:
            self.warmup()
        if self._loop is None:
            return self._run_host_loop()
        self._session(self._pump, emit=True)
        return self.results()

    def _check_not_stale(self):
        if self._stale:
            raise RuntimeError("PersistentOnlineDecoder: the last session ended with packets in "
                               "flight (decoded but not emitted, or received but not decoded); "
                               "call reset()")

    def _run_host_loop(self):
        """The loop's plain version, on the CPU: the JAX loop body per packet."""
        while True:
            packet, flag = self._queue.get()
            if flag == self._DATA:
                self.tracer.mark("packet_in")
            new, out = self.step(self.carry, self._to_device(packet))
            pipeline.commit_carry(self.carry, new, torch.tensor(flag == self._DATA))
            if flag != self._DATA:
                return self.results()
            self._stale = True
            self._emit(out)
            self._stale = False

    def _session(self, feed, emit: bool):
        """One graph launch: ``feed(loop, halt)`` runs in a pump thread and
        writes packets into the ring until it has written a STOP packet;
        this thread reads each output as it lands (``emit``: hands it to
        ``_emit_rows``) until the STOP iteration's.  Every way out of here
        that is not that STOP sets the abort word, waits for the loop's
        stream and re-raises; if the device had decoded data packets whose
        outputs were not emitted, or had not taken every packet written into
        the ring, the decoder is stale until ``reset()``."""
        loop, halt, errors = self._loop, threading.Event(), []

        def pump():
            try:
                feed(loop, halt)
            except BaseException as e:  # raised in the caller below
                errors.append(e)
                loop.abort()

        thread = threading.Thread(target=pump, daemon=True)
        clean = False
        try:
            loop.launch()
            thread.start()
            seq = loop.consumed
            while True:
                seq += 1
                while (rc := loop.wait_done(seq, self._POLL_S)) != cuda_loop.DONE:
                    if errors:
                        raise errors[0]
                    if rc == cuda_loop.ABORTED:
                        raise RuntimeError("persistent loop aborted")
                slot = loop.slot(seq)
                if int(loop.flags[slot]) != self._DATA:
                    loop.release(seq)
                    break
                self.tracer.mark("step_done")
                if emit:
                    with span("seeg.online.emit"):
                        self._emit_rows(*(np.array(o[slot]) for o in loop.outputs))
                loop.release(seq)
            clean = True
        finally:
            halt.set()
            if not clean:
                loop.abort()
            if thread.is_alive():
                thread.join()
            unread = loop.finish(aborted=not clean)
            self._stale = unread > 0 or self._seq > loop.taken
            self._seq = loop.taken
        if errors:
            raise errors[0]

    def _publish(self, loop, packet, flag, halt) -> bool:
        """Write the next packet into the ring once its slot is free; False
        when the session was aborted or halted first."""
        seq = self._seq + 1
        while (rc := loop.wait_free(seq, self._POLL_S)) != cuda_loop.DONE:
            if rc == cuda_loop.ABORTED or halt.is_set():
                return False
        if flag == self._DATA:
            self.tracer.mark("packet_in")
        loop.publish(seq, packet, flag)
        self._seq = seq
        return True

    def _pump(self, loop, halt):
        """The session's pump thread: queued packets into the ring, in order,
        up to and including the first STOP packet."""
        while not halt.is_set():
            try:
                packet, flag = self._queue.get(timeout=self._POLL_S)
            except queue.Empty:
                continue
            if not self._publish(loop, packet, flag, halt) or flag != self._DATA:
                return

    def reset(self):
        """Reset the streaming state for a new session: the static carry is
        rewritten in place (the loop's graph holds its addresses), queued
        packets are dropped, the outputs cleared and a stale carry (after an
        aborted session) is usable again."""
        with self._queue_lock:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        self._restore_carry()
        self.spec_frames, self.audio_chunks, self.received = [], [], []
        self._stale = False

    def run_stream(self, stream, stop_event: threading.Event | None = None,
                   max_packets: int | None = None, store_first_timestamp_to: str | None = None,
                   backend=None, idle_timeout: float = 30.0):
        """Pull from a live stream until stopped: the persistent twin of
        ``OnlineDecoder.run_stream``.  The loop is warmed up before a named
        stream is subscribed to; a feeder thread re-blocks inlet chunks into
        packets and feeds them, and always feeds STOP when it ends, so a
        feeder crash releases the loop and is raised here.  With
        ``max_packets``, a stream that closes or idles short raises."""
        self._check_not_stale()
        if not self._warm:
            self.warmup()
        inlet = StreamInlet(stream, backend=backend) if isinstance(stream, str) else stream
        rebuf = PacketRebuffer(self.cfg.packet_size, inlet.channels)
        done = threading.Event()
        stopped = _AnySet(stop_event, done)
        feeder_error = []

        def feeder():
            try:
                n, why = _pump_stream(inlet, rebuf, self.cfg.packet_size, self.feed_packet,
                                      stopped, max_packets, store_first_timestamp_to,
                                      idle_timeout)
                _check_complete(inlet, stream, n, why, max_packets)
            except BaseException as e:  # raised in the caller after join
                feeder_error.append(e)
            finally:
                self.feed_stop()

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            out = self.run_until_stopped()
        finally:
            done.set()
            t.join()
        if feeder_error:
            raise feeder_error[0]
        return out


class _AnySet:
    """An event view that is set when any of its events is (None: never)."""

    def __init__(self, *events):
        self.events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self.events)


def read_markers(run_dir: str, stream_name: str = "SingleWordsMarkerStream",
                 stop_event=None, backend=None, timeout: float = 10.0):
    """Marker logger (twin of local/marker.py): appends
    ``walltime,stream_timestamp,label`` rows to markers.csv, flushing each
    sample; run in a side process/thread to stay off the decode hot path
    (decode.py:128-137)."""
    import datetime
    import os

    try:
        inlet = StreamInlet(stream_name, timeout=timeout, backend=backend)
    except TimeoutError:
        logger.warning("marker stream %r not found; marker logging disabled", stream_name)
        return
    path = os.path.join(run_dir, "markers.csv")
    # truncate like the reference (local/marker.py opens "w"): reruns into the
    # same run_dir must not mix stale markers into DecodingRun trial starts
    with open(path, "w") as f:
        while not (stop_event and stop_event.is_set()):
            try:
                label, ts = inlet.pull_string(timeout=0.25)
            except ConnectionError:
                logger.info("marker stream closed; marker logging done")
                break
            if label is None:
                continue
            wall = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
            f.write(f"{wall},{ts},{label}\n")
            f.flush()
