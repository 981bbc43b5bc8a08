"""Rank 0 controls, the other ranks follow: the control plane of serving
under tensor, sequence, pipeline and data parallelism.

The JAX package is one controller over every chip, and the reference's
workers loop on a control packet {position, batchSize} that the root
broadcasts before each forward, batchSize 0 being the stop signal
(src/app.cpp:197-230). The port runs one process a rank, and only rank 0
sees the requests of a server or the lines of a chat. So rank 0 runs the
scheduler, the HTTP server or the chat loop, and `Controller` sends each
engine dispatch to the other ranks before it runs the dispatch itself;
every other rank runs `follow`, which runs each command on its own
engine until it receives ``stop`` (the reference's batchSize 0).

* **A command** names one leaf dispatch of the engine (`DISPATCHES`), its
  host arguments (ints, lists, small numpy arrays), the engine's sampling
  settings of the moment (the server sets them a request) and every value
  rank 0 drew for it: the block seed, the lanes' seeds and the chaos
  plane's outcome (none, transient or poison), recorded through the
  engine's ``tape`` as rank 0 draws them. A follower replays those values
  and never draws its own; its fault plane stays empty. So a poison on
  rank 0 resets the same cache and moves ``cache_epoch`` on every rank,
  and a transient fault, raised before a dispatch's device work, is raised
  on rank 0 before anything is sent.
* **When it is sent.** At the dispatch's first device work (the engine's
  dispatch bracket calls ``tape.launch()``), after its host checks and its
  draws; a dispatch that changes host state only (a page-table row, a
  seed) is sent once it has returned; one that raises before any device
  work is not sent at all.
* **What is mirrored: leaf dispatches only.** ``generate``,
  ``generate_batch``, ``prefill_lane`` and the chat loop run on rank 0
  alone, and their leaf dispatches are sent one by one, so a stop decided
  by rank 0's EOS detector stays on rank 0. A dispatch called from inside
  another (a guard's pool reset, ``reset_kv_pool``'s page-table clear) is
  not sent again: a depth count. Host-only reads (``occupancy``,
  ``cost_report``, ``graph_report``, ``device_step_seconds``,
  ``kv_page_bytes``) are not mirrored.
* **Order.** One lock around each send and run, so the commands reach the
  followers in the order rank 0 runs them, whichever of the scheduler
  thread, an HTTP handler or the rehearsal reaches the engine.
* **The channel.** A gloo process group of its own (under NCCL the data
  collectives stay on the device; the control group carries pickled host
  objects only), with its own timeout. An idle server sends nothing for
  minutes, so rank 0 sends a heartbeat whenever it has sent nothing for
  ``heartbeat_s``: a follower blocked in its receive then ends within the
  timeout only if rank 0 is gone, and a dead follower fails rank 0's next
  send (`ControlLost`; ``lost`` is set).
* **A consistency check.** Each rank folds the tokens every mirrored call
  returns into a digest (`Controller.summary`, `follow`'s result); equal
  digests mean every rank returned the same tokens. A host-sampled
  ``decode_step`` is drawn on rank 0 alone and is left out.
* **Pipeline stages and dp groups.** Rank 0 is stage 0 of dp group 0 and
  every other rank, of any stage and group, follows the same commands: the
  engine splits each dispatch into its stage's part and its group's lanes
  (runtime/engine.py) and hands every rank every lane's tokens, so every
  digest is equal. Kernel launches differ between dp groups (a lane's
  chunk runs on its group alone): a check of launches compares the ranks
  of one stage and dp group. The ranks of a tp group run a Qwen3-MoE
  layer's routing on the same rows (models/transformer.moe_ffn), so they
  take the same two-tier decode tier and launch the same kernels: their
  launches and ``ops.moe.tier_tally`` compare equal.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import pickle
import threading
import time

import torch.distributed as dist

from ..runtime.faults import InjectedFault, set_fault_plane
from .mesh import DEFAULT_TIMEOUT_S

# the engine's leaf dispatches, mirrored one by one
DISPATCHES = (
    "prefill", "decode_step", "decode_block", "reset", "set_seed", "init_kv_pool",
    "reset_kv_pool", "adopt_pages", "clear_lane_pages", "clear_all_lane_pages",
    "kv_page_copy", "kv_adopt", "kv_publish", "prefill_lane_chunk", "decode_lanes",
    "verify_lanes", "rehearse_admission", "init_draft_model", "draft_prefill", "draft_propose",
)
HEARTBEAT, STOP = "heartbeat", "stop"
# the dispatches whose return holds tokens (the consistency digest)
_TOKEN_RETURNS = ("decode_step", "decode_block", "decode_lanes", "verify_lanes",
                  "draft_propose", "prefill_lane_chunk")


class ControlLost(RuntimeError):
    """A send of the control plane failed: a rank is gone."""


@dataclasses.dataclass
class Command:
    """One mirrored dispatch: its name, its host arguments, the engine's
    sampling settings and rank 0's draws, in the order drawn."""

    name: str
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    draws: list = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    topp: float = 0.9


def _encode(value):
    """A draw as a picklable value: an `InjectedFault` by its fields."""
    if isinstance(value, InjectedFault):
        return ("fault", value.site, value.op, value.kind, value.seq)
    return ("value", value)


def _decode(item):
    if item[0] == "fault":
        return InjectedFault(*item[1:])
    return item[1]


class _RecordTape:
    """Rank 0's tape: each draw is made here and recorded in the pending
    command; the first device work sends the command."""

    def __init__(self, ctl: "Controller", cmd: Command):
        self.ctl, self.cmd = ctl, cmd

    def draw(self, fn):
        value = fn()
        self.cmd.draws.append(_encode(value))
        return value

    def launch(self) -> None:
        self.ctl._send_pending_locked()  # called inside the Controller's call()


class _ReplayTape:
    """A follower's tape: rank 0's draws in order; a draw rank 0 made after
    it sent the command (a host sample) is not replayed: None."""

    def __init__(self, draws: list):
        self.draws = list(draws)

    def draw(self, fn):
        del fn  # a follower draws nothing of its own
        return _decode(self.draws.pop(0)) if self.draws else None

    def launch(self) -> None:
        pass


def control_group(timeout_s: float):
    """The control plane's gloo group over every rank, with its own
    timeout (every rank calls this at the same point: it is a collective)."""
    return dist.new_group(list(range(dist.get_world_size())), backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))


class _Digest:
    """The tokens of every mirrored call folded into one hash."""

    def __init__(self):
        self._h = hashlib.sha256()
        self.n = 0

    def add(self, name: str, out, temperature: float) -> None:
        if name not in _TOKEN_RETURNS or out is None:
            return
        if name == "decode_step":
            if temperature != 0.0:
                return  # host-sampled on rank 0 alone
            out = out[0]
        self._h.update(pickle.dumps((name, out)))
        self.n += 1

    def hexdigest(self) -> str:
        return self._h.hexdigest()


class Controller:
    """Rank 0's side (module docstring): wraps the engine's `DISPATCHES` on
    this instance, so that every caller of the engine goes through it.
    ``timeout_s`` bounds each send; a quarter of it, at most 5 s, is the
    longest it stays silent (``heartbeat_s``). `stop` sends ``stop`` and
    unwraps the engine."""

    def __init__(self, engine, mesh, timeout_s: float = DEFAULT_TIMEOUT_S):
        if mesh.rank != 0:
            raise ValueError("the controller runs on rank 0")
        self.engine, self.mesh = engine, mesh
        self.group = control_group(timeout_s)
        self.heartbeat_s = min(5.0, timeout_s / 4)
        self.lost = threading.Event()
        self.error: BaseException | None = None
        self.commands = 0
        self._lock = threading.RLock()
        self._depth = 0
        self._pending: Command | None = None
        self._digest = _Digest()
        self._stopped = False
        self._last_send = time.monotonic()
        for name in DISPATCHES:
            setattr(engine, name, self._wrap(name, getattr(engine, name)))
        self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                      name="dllama-control-heartbeat")
        self._beat.start()

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with self._lock:
                if self._depth:  # inside another mirrored dispatch
                    return fn(*args, **kwargs)
                if self.lost.is_set() or self._stopped:
                    state = "lost" if self.lost.is_set() else "stopped"
                    raise ControlLost(f"the control plane is {state}; {name} not run") \
                        from self.error
                engine = self.engine
                cmd = Command(name, args, kwargs, [], engine.temperature, engine.sampler.topp)
                self._pending = cmd
                self._depth += 1
                engine.tape = _RecordTape(self, cmd)
                try:
                    out = fn(*args, **kwargs)
                except BaseException:
                    self._pending = None  # raised before any device work: not sent
                    raise
                finally:
                    self._depth -= 1
                    engine.tape = None
                if self._pending is not None:  # host state only: sent once done
                    self._send_pending_locked()
                self._digest.add(name, out, cmd.temperature)
                return out

        return call

    def _send_pending_locked(self) -> None:
        """Send the pending command once. Called under ``_lock``: from
        ``call`` and from its tape's ``launch``, which the engine calls
        inside the wrapped dispatch on the caller's thread, so the
        heartbeat never broadcasts on the group at the same time."""
        cmd, self._pending = self._pending, None
        if cmd is not None:
            self._send(cmd)
            self.commands += 1

    def _send(self, cmd: Command) -> None:
        try:
            dist.broadcast_object_list([cmd], src=0, group=self.group)
        except BaseException as e:
            self.error = e
            self.lost.set()
            raise ControlLost(f"the control plane lost a rank sending {cmd.name}: {e}") from e
        self._last_send = time.monotonic()

    def _heartbeat(self) -> None:
        while True:
            time.sleep(self.heartbeat_s / 4)
            with self._lock:
                if self._stopped or self.lost.is_set():
                    return
                if time.monotonic() - self._last_send < self.heartbeat_s:
                    continue
                try:
                    self._send(Command(HEARTBEAT))
                except ControlLost:
                    return

    def summary(self) -> dict:
        """The commands sent and the digest of the tokens returned."""
        with self._lock:
            return {"commands": self.commands, "returns": self._digest.n,
                    "digest": self._digest.hexdigest()}

    def stop(self) -> dict:
        """Send ``stop`` (every follower's `follow` returns), unwrap the
        engine and return `summary`. Idempotent."""
        with self._lock:
            if not self._stopped:
                try:
                    if not self.lost.is_set():
                        self._send(Command(STOP))
                finally:
                    self._stopped = True
                    for name in DISPATCHES:
                        self.engine.__dict__.pop(name, None)
        self._beat.join(timeout=self.heartbeat_s)
        return self.summary()


def follow(engine, mesh, timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """A follower's loop (module docstring): receive each command, apply
    rank 0's sampling settings and draws, run the dispatch on this rank's
    engine, until ``stop``. A replayed injected fault is the same failure
    rank 0 had (its guard reset the same cache here); any other error ends
    the loop and the launch. Returns the commands run and the digest of the
    tokens returned."""
    if mesh.rank == 0:
        raise ValueError("rank 0 controls; the other ranks follow")
    group = control_group(timeout_s)
    set_fault_plane("")  # a follower draws nothing, whatever DLLAMA_FAULTS says
    digest, n = _Digest(), 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        cmd: Command = box[0]
        if cmd.name == STOP:
            break
        if cmd.name == HEARTBEAT:
            continue
        engine.temperature = cmd.temperature
        engine.sampler.set_temp(cmd.temperature)
        engine.sampler.set_topp(cmd.topp)
        engine.tape = _ReplayTape(cmd.draws)
        try:
            out = getattr(engine, cmd.name)(*cmd.args, **cmd.kwargs)
        except InjectedFault:
            out = None
        finally:
            engine.tape = None
        digest.add(cmd.name, out, cmd.temperature)
        n += 1
    return {"commands": n, "returns": digest.n, "digest": digest.hexdigest()}


def lead_or_follow(engine, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Under world > 1: a `Controller` on rank 0; on every other rank run
    `follow` to its end and return its summary dict. None for one rank."""
    if engine.world == 1:
        return None
    if engine.mesh.rank == 0:
        return Controller(engine, engine.mesh, timeout_s)
    return follow(engine, engine.mesh, timeout_s)
