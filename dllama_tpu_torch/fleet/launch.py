"""Fleet topologies: bring up N replicas + the front door.

    python -m dllama_tpu_torch.fleet.launch --model m.m --tokenizer t.t \\
        --n-replicas 2 --base-port 9990 --port 9980 --batch-size 4 [--device cpu]

Two modes:

* :func:`launch_inprocess_fleet` — N port engines + N ``api_server``
  instances + one router, all in this process: deterministic (shared
  seeds), cheap to tear down, and — since the obs registry and flight
  recorder are process-global — a single ``/metrics`` scrape on ANY port
  already aggregates the whole fleet. Each replica gets a ``replica_id``
  (``r0``, ``r1``, ...) so seeded chaos can target exactly one of them
  (``sse_flush:op=r1:nth=3``). On one card the replicas' engines share
  the card and its default stream: their steps serialize.
* ``main()`` — the ops entry point: spawns each replica as its own
  ``python -m dllama_tpu_torch.runtime.api_server`` subprocess (its own
  CUDA context, its own metrics), waits for their health endpoints,
  then runs the router in the foreground; SIGTERM or SIGINT drains each
  replica (its own SIGTERM) and stops the router.

Both build their engines on ``cuda`` unless given ``device="cpu"`` /
``--device cpu``, and raise without a card, as every entry point of the
port does; a replica that fails to build fails the launch.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from dataclasses import dataclass, field

from ..tokenizer import ChatTemplateType, Tokenizer
from .replicas import ReplicaRegistry
from .router import resolve_fleet_knobs, serve_router


@dataclass
class FleetHandle:
    """Everything a caller needs to drive and tear down a fleet."""

    router: object                      # ThreadingHTTPServer (router)
    replicas: list[tuple[str, object]]  # (name, ThreadingHTTPServer)
    registry: ReplicaRegistry
    threads: list[threading.Thread] = field(default_factory=list)

    @property
    def router_url(self) -> str:
        return f"http://127.0.0.1:{self.router.server_address[1]}"

    @property
    def replica_urls(self) -> dict[str, str]:
        return {
            name: f"http://127.0.0.1:{srv.server_address[1]}"
            for name, srv in self.replicas
        }

    @property
    def router_state(self):
        """The router's :class:`~.router.RouterState` — callers reach
        the fleet observability plane here
        (``.fleet`` for scrape/sampler/monitor, ``.spans`` for router
        spans, ``.ledger`` for request history)."""
        return self.router.state

    def close(self) -> None:
        self.router.shutdown()
        self.router.server_close()  # stops the health poller too
        for _, srv in self.replicas:
            srv.shutdown()
            srv.server_close()


def launch_inprocess_fleet(
    model_path: str,
    tokenizer_path: str,
    n_replicas: int = 2,
    batch_size: int = 2,
    chat_template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
    engine_kwargs: dict | None = None,
    serve_kwargs: dict | None = None,
    router_kwargs: dict | None = None,
    device: str | None = None,
) -> FleetHandle:
    """N lane-scheduler replicas of one model + the router, all on
    127.0.0.1 ephemeral ports. Every replica decodes greedily with the
    same seed, which is what makes mid-stream failover byte-identity
    testable: any replica continues any sibling's stream exactly.

    Each replica's engine is an ``InferenceEngine`` on ``device`` (None:
    ``cuda``, which raises without a card), f32, temperature 0 and seed
    3 unless ``engine_kwargs`` say otherwise; ``serve_kwargs`` go to each
    replica's ``serve``, ``router_kwargs`` to ``serve_router``. A replica
    that fails to build closes the ones already up and re-raises."""
    import torch

    from ..runtime.api_server import serve
    from ..runtime.engine import InferenceEngine

    if n_replicas < 1:
        raise ValueError(f"need at least one replica, got {n_replicas}")
    ekw = dict(
        dtype=torch.float32, temperature=0.0, seed=3,
        batch_size=batch_size, device=device,
    )
    ekw.update(engine_kwargs or {})
    skw = dict(serve_kwargs or {})
    replicas: list[tuple[str, object]] = []
    threads: list[threading.Thread] = []
    try:
        for i in range(n_replicas):
            name = f"r{i}"
            # independent Tokenizer per replica: encode is stateless but
            # the tokenizer's own incremental decoder is not, and replicas
            # must not share mutable state
            tok = Tokenizer(tokenizer_path)
            engine = InferenceEngine(model_path, **ekw)
            srv = serve(
                engine, tok, host="127.0.0.1", port=0,
                chat_template_type=chat_template_type,
                replica_id=name, **skw,
            )
            # serve_forever returns at FleetHandle.close()'s shutdown()
            t = threading.Thread(  # dlint: disable=thread-hygiene — serve_forever returns at FleetHandle.close()'s shutdown(); the daemon thread exits with it
                target=srv.serve_forever, daemon=True,
                name=f"fleet-replica-{name}",
            )
            t.start()
            replicas.append((name, srv))
            threads.append(t)
    except BaseException:
        for _, srv in replicas:
            srv.shutdown()
            srv.server_close()
        raise
    registry = ReplicaRegistry(
        {
            name: f"http://127.0.0.1:{srv.server_address[1]}"
            for name, srv in replicas
        },
        poll_interval_s=0.5,
    )
    rkw = dict(
        chat_template_type=chat_template_type,
        stall_timeout_s=30.0,
    )
    rkw.update(router_kwargs or {})
    router = serve_router(
        registry, Tokenizer(tokenizer_path), host="127.0.0.1", port=0,
        **rkw,
    )
    rt = threading.Thread(  # dlint: disable=thread-hygiene — serve_forever returns at FleetHandle.close()'s shutdown(); the daemon thread exits with it
        target=router.serve_forever, daemon=True, name="fleet-router"
    )
    rt.start()
    threads.append(rt)
    return FleetHandle(
        router=router, replicas=replicas, registry=registry,
        threads=threads,
    )


def _wait_health(url: str, timeout_s: float = 120.0, proc=None) -> None:
    deadline = time.monotonic() + timeout_s
    last = "no attempt"
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"replica at {url} exited with code {proc.returncode}"
            )
        try:
            with urllib.request.urlopen(f"{url}/v1/health", timeout=5.0):
                return
        except OSError as e:
            last = f"{type(e).__name__}: {e}"
            time.sleep(0.5)
    raise TimeoutError(f"replica at {url} never became healthy ({last})")


def main(argv=None) -> None:
    """Ops entry: N replica subprocesses + the router in the foreground.

    python -m dllama_tpu_torch.fleet.launch --model m.m --tokenizer t.t \\
        --n-replicas 2 --base-port 9990 --port 9980 --batch-size 4
    """
    import argparse
    import signal
    import subprocess
    import sys

    from ..tokenizer import CHAT_TEMPLATE_NAMES

    parser = argparse.ArgumentParser(
        prog="dllama-tpu-torch-fleet",
        description="Spawn an N-replica fleet + router",
    )
    parser.add_argument("--model", required=True)
    parser.add_argument("--tokenizer", required=True)
    parser.add_argument("--n-replicas", type=int, default=2)
    parser.add_argument("--base-port", type=int, default=9990,
                        help="replica i listens on base-port + i")
    parser.add_argument("--port", type=int, default=9980,
                        help="router port")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--max-streams", type=int, default=None)
    parser.add_argument("--chat-template", default=None,
                        choices=sorted(CHAT_TEMPLATE_NAMES))
    parser.add_argument("--routing", default="affinity",
                        choices=("affinity", "random"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="every replica's device (cuda: the launch "
                        "fails without a card)")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "--device cuda but torch.cuda.is_available() is False; "
                "pass --device cpu to run the plain PyTorch versions"
            )

    procs: list[subprocess.Popen] = []
    replicas: dict[str, str] = {}
    server = None
    try:
        t0 = time.monotonic()
        for i in range(args.n_replicas):
            name, port = f"r{i}", args.base_port + i
            cmd = [
                sys.executable, "-m", "dllama_tpu_torch.runtime.api_server",
                "--model", args.model, "--tokenizer", args.tokenizer,
                "--host", args.host, "--port", str(port),
                "--batch-size", str(args.batch_size),
                "--replica-id", name, "--device", args.device,
                "--tp", "1",  # a replica is one rank (the server's --tp 0 takes every card)
            ]
            if args.max_streams is not None:
                cmd += ["--max-streams", str(args.max_streams)]
            if args.chat_template:
                cmd += ["--chat-template", args.chat_template]
            procs.append(subprocess.Popen(cmd))
            replicas[name] = f"http://{args.host}:{port}"
        for (name, url), proc in zip(replicas.items(), procs):
            _wait_health(url, proc=proc)
            print(f"Replica {name} healthy after "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        _, _, _, poll_s = resolve_fleet_knobs()
        registry = ReplicaRegistry(replicas, poll_interval_s=poll_s)
        ttype = (
            CHAT_TEMPLATE_NAMES[args.chat_template]
            if args.chat_template
            else ChatTemplateType.UNKNOWN
        )
        server = serve_router(
            registry, Tokenizer(args.tokenizer),
            host=args.host, port=args.port,
            chat_template_type=ttype, routing=args.routing,
        )
        srv = server

        def on_term(signum, frame):
            # serve_forever returns; the finally below drains the replicas
            threading.Thread(  # dlint: disable=thread-hygiene — shutdown() ends serve_forever, whose finally drains the replicas and exits
                target=srv.shutdown, daemon=True, name="dllama-fleet-stop").start()

        signal.signal(signal.SIGTERM, on_term)
        print(
            f"Fleet router: http://{args.host}:{args.port}/v1/ "
            f"({len(replicas)} replicas)\n"
            f"Fleet dashboard: http://{args.host}:{args.port}/dashboard "
            f"· metrics: /metrics · timelines: /v1/fleet/timeline",
            flush=True,
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        if server is not None:
            server.server_close()
        for p in procs:
            p.terminate()  # SIGTERM = graceful drain on the replica
        for p in procs:
            try:
                p.wait(timeout=90.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


if __name__ == "__main__":
    main()
