# The port's copy of ray_tpu/scripts/scripts.py
"""CLI (parity: ``python/ray/scripts/scripts.py``): status, list, summary,
timeline, memory, microbenchmark, dashboard against a live session.

Usage: ``python -m ray_tpu_torch.scripts <command> [...]`` (also installed as
the ``ray-tpu`` entrypoint).  Commands attach to the newest live session's
control-plane socket, so they work from any terminal on the node.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from typing import Optional


def _find_session_cp_sock() -> Optional[str]:
    """The first session that answers: the calling process's parent's
    own first, then newest first (``_private/node.py:
    _session_candidates``); a shut-down session leaves its directory."""
    from ray_tpu_torch._private.node import _session_candidates
    from ray_tpu_torch._private.protocol import RpcClient
    candidates = _session_candidates()
    for addr, _session in candidates:
        try:
            RpcClient(addr, connect_timeout=2.0).ping()
            return addr
        except Exception:  # noqa: BLE001 — a dead session
            continue
    return candidates[0][0] if candidates else None


def _connect_cp():
    from ray_tpu_torch._private.protocol import RpcClient
    sock = _find_session_cp_sock()
    if sock is None:
        print("No live ray_tpu_torch session found on this node.",
              file=sys.stderr)
        sys.exit(1)
    client = RpcClient(sock)
    try:
        client.call("ping")
    except (OSError, ConnectionError):
        print("Session socket exists but the control plane is not "
              "responding.", file=sys.stderr)
        sys.exit(1)
    return client


def cmd_status(args):
    cp = _connect_cp()
    nodes = cp.call("list_nodes")
    print(f"{'NODE':34} {'STATE':8} {'CPU':>10} {'GPU':>8} PENDING")
    for n in nodes:
        total = n.get("resources_total", {})
        avail = n.get("resources_available", {})
        cpu = f"{avail.get('CPU', 0):.0f}/{total.get('CPU', 0):.0f}"
        gpu = f"{avail.get('GPU', 0):.0f}/{total.get('GPU', 0):.0f}" \
            if total.get("GPU") else "-"
        load = n.get("load", {}).get("num_pending", 0)
        print(f"{n['node_id'].hex():34} {n['state']:8} {cpu:>10} "
              f"{gpu:>8} {load}")
    counters = cp.call("counters")
    if counters:
        print("\ncounters:")
        for k, v in sorted(counters.items())[:20]:
            print(f"  {k}: {v}")


def _parse_filter(expr: str):
    """``key<op>value`` -> (key, op, value); ops: != >= <= = > <``."""
    for op in ("!=", ">=", "<=", "=", ">", "<"):
        if op in expr:
            key, val = expr.split(op, 1)
            return (key.strip(), op, val.strip())
    raise SystemExit(f"bad --filter {expr!r} (want key=value)")


def cmd_list(args):
    cp = _connect_cp()
    kind = args.kind
    if kind == "nodes":
        rows = [{**n, "node_id": n["node_id"].hex()}
                for n in cp.call("list_nodes")]
    elif kind == "actors":
        rows = []
        for a in cp.call("list_actors"):
            rows.append({"actor_id": a["actor_id"].hex(),
                         "class": a.get("class_name"),
                         "state": a.get("state"),
                         "name": a.get("name"),
                         "pid": a.get("pid")})
    elif kind == "tasks":
        events = cp.call("list_task_events", 1000)
        latest = {}
        for ev in events:
            latest[ev["task_id"]] = ev
        rows = list(latest.values())
    elif kind == "objects":
        rows = cp.call("list_objects")[:100]
    elif kind == "placement-groups":
        rows = [{**p, "pg_id": p["pg_id"].hex()}
                for p in cp.call("list_placement_groups")]
    else:
        print(f"unknown kind {kind}", file=sys.stderr)
        sys.exit(1)
    if getattr(args, "filter", None):
        from ray_tpu_torch.util.state import _match
        for expr in args.filter:
            key, op, val = _parse_filter(expr)
            rows = [r for r in rows if _match(r, key, op, val)]
    limit = getattr(args, "limit", None)
    if limit is not None:
        rows = rows[:limit]
    for row in rows:
        print(json.dumps(row, default=str))


def cmd_logs(args):
    """``ray-tpu logs`` — list worker/daemon log files across nodes;
    ``ray-tpu logs <name>`` tails one (parity: ``ray logs``,
    ``util/state/state_cli.py`` logs subcommand)."""
    from ray_tpu_torch._private.protocol import RpcClient
    cp = _connect_cp()
    nodes = [n for n in cp.call("list_nodes")
             if n.get("state") == "ALIVE"]
    if args.node:
        nodes = [n for n in nodes
                 if n["node_id"].hex().startswith(args.node)]
        if not nodes:
            raise SystemExit(f"no alive node matches {args.node!r}")
    if not args.name:
        for n in nodes:
            nid = n["node_id"].hex()
            try:
                logs = RpcClient(n["sock_path"]).call("list_logs")
            except (OSError, ConnectionError) as e:
                print(f"[{nid[:12]}] unreachable: {e}", file=sys.stderr)
                continue
            for entry in logs:
                print(f"{nid[:12]}  {entry['size']:>10}  "
                      f"{entry['name']}")
        return
    for n in nodes:
        try:
            data = RpcClient(n["sock_path"]).call(
                "tail_log", args.name, args.tail)
        except (OSError, ConnectionError):
            continue  # node unreachable: try the rest
        if data is None:
            continue  # this node doesn't have the file
        sys.stdout.write(data.decode(errors="replace"))
        return
    raise SystemExit(f"log {args.name!r} not found on any node")


def cmd_summary(args):
    cp = _connect_cp()
    events = cp.call("list_task_events", 100000)
    states = {}
    for ev in events:
        states[ev.get("state")] = states.get(ev.get("state"), 0) + 1
    actors = cp.call("list_actors")
    astates = {}
    for a in actors:
        astates[a.get("state")] = astates.get(a.get("state"), 0) + 1
    print("task events:", json.dumps(states))
    print("actors:", json.dumps(astates))
    print("objects:", json.dumps(cp.call("objects_summary")))


def cmd_timeline(args):
    cp = _connect_cp()
    from ray_tpu_torch._private.profiling import chrome_tracing_dump
    events = cp.call("list_task_events", 100000)
    out = args.output or "timeline.json"
    chrome_tracing_dump(events, out)
    print(f"wrote {out} ({len(events)} events); open in "
          "chrome://tracing or https://ui.perfetto.dev")


def cmd_memory(args):
    cp = _connect_cp()
    objs = cp.call("list_objects")
    total = sum(o.get("size", 0) for o in objs)
    print(f"{len(objs)} objects, {total / 2**20:.1f} MiB")
    for o in sorted(objs, key=lambda o: -o.get("size", 0))[:20]:
        print(f"  {o['object_id'][:16]}  {o.get('size', 0):>12}  "
              f"{o.get('where')}")


def cmd_stack(args):
    """Dump python stacks of every worker on every node (reference:
    ``ray stack`` via py-spy; here workers' registered faulthandlers
    write to their session log files on SIGUSR1)."""
    import glob
    import os
    import time

    from ray_tpu_torch._private import protocol
    cp = _connect_cp()
    total = []
    session_dirs = set()
    for info in cp.call("list_nodes"):
        if info.get("state") != "ALIVE":
            continue
        session_dirs.add(info.get("session_dir", ""))
        try:
            pids = protocol.RpcClient(info["sock_path"]).call(
                "signal_stack_dump")
            total.extend(pids)
            print(f"node {info['node_id'].hex()[:12]}: signalled "
                  f"{len(pids)} workers")
        except (OSError, ConnectionError) as e:
            print(f"node {info['node_id'].hex()[:12]}: unreachable ({e})")
    time.sleep(0.7)          # give faulthandler time to write
    shown = 0
    for sdir in session_dirs:
        for log in sorted(glob.glob(os.path.join(sdir, "logs",
                                                 "worker-*.log"))):
            try:
                with open(log) as f:
                    tail = f.readlines()[-120:]
            except OSError:
                continue
            # show from the LAST dump onward (one "Current thread"
            # header per faulthandler dump; older dumps are stale)
            start = None
            for i, line in enumerate(tail):
                if "Current thread" in line:
                    start = i
                elif start is None and "Thread 0x" in line:
                    start = i
            if start is not None:
                print(f"\n===== {os.path.basename(log)} =====")
                print("".join(tail[start:]).rstrip())
                shown += 1
    print(f"\n{len(total)} workers signalled, {shown} stack dumps shown")


def cmd_microbenchmark(args):
    import ray_tpu_torch
    from ray_tpu_torch._private import ray_perf
    ray_tpu_torch.init()
    try:
        ray_perf.main(duration=args.duration)
    finally:
        ray_tpu_torch.shutdown()


def cmd_dashboard(args):
    import ray_tpu_torch
    ray_tpu_torch.init(ignore_reinit_error=True)
    from ray_tpu_torch.dashboard.app import Dashboard
    port = Dashboard(args.port).start()
    print(f"dashboard at http://127.0.0.1:{port}")
    import time
    while True:
        time.sleep(3600)


_HEAD_DAEMON = """
import signal
# block BEFORE sigwait: with the default disposition unblocked SIGTERM
# would kill the process and skip the graceful shutdown
signal.pthread_sigmask(signal.SIG_BLOCK, {{signal.SIGTERM,
                                           signal.SIGINT}})
import ray_tpu_torch
ray_tpu_torch.init(_system_config={system_config!r}, **{kwargs!r})
from ray_tpu_torch._private.worker import global_node
print("ray_tpu_torch head up:", global_node().cp_sock_path, flush=True)
signal.sigwait({{signal.SIGTERM, signal.SIGINT}})
ray_tpu_torch.shutdown()
"""


def _pidfile() -> str:
    import getpass
    return os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch_{getpass.getuser()}",
                        "daemons.pids")


def _record_pid(pid: int) -> None:
    path = _pidfile()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{pid}\n")


def cmd_start(args):
    """``ray-tpu start --head`` / ``--address`` — standalone daemons
    (parity: ``ray start``).  The head runs as its own process; drivers
    attach with ``init(address='auto')``; worker nodes on any host join
    a TCP head with --address."""
    import subprocess
    import uuid
    if args.head:
        system_config = {}
        if args.tcp:
            system_config["use_tcp"] = True
            if args.node_ip:
                system_config["node_ip"] = args.node_ip
        if args.persist:
            system_config["cp_persistence"] = True
        kwargs = {}
        if args.num_cpus is not None:
            kwargs["num_cpus"] = args.num_cpus
        if args.num_gpus is not None:
            kwargs["num_gpus"] = args.num_gpus
        code = _HEAD_DAEMON.format(kwargs=kwargs,
                                   system_config=system_config)
        log_dir = os.path.dirname(_pidfile())
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, "head.log")
        log = open(log_path, "ab")
        # log file, not a pipe: the daemon outlives this CLI, and later
        # stdout writes to an abandoned pipe would BrokenPipeError it
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        log.close()
        deadline = time.time() + 60
        addr = None
        while time.time() < deadline:
            if proc.poll() is not None:
                with open(log_path) as f:
                    tail = f.read()[-2000:]
                print(f"head daemon exited rc={proc.returncode}:\n"
                      f"{tail}", file=sys.stderr)
                sys.exit(1)
            # the daemon's own session (named after its pid), not
            # whichever session on this host is newest
            from ray_tpu_torch._private.node import _session_candidates
            found = [c for c in _session_candidates()
                     if c[1].endswith(f"_{proc.pid}")]
            if found:
                try:
                    from ray_tpu_torch._private.protocol import RpcClient
                    RpcClient(found[0][0], connect_timeout=2.0).ping()
                    addr = found[0][0]
                    break
                except Exception:  # noqa: BLE001 — not up yet
                    pass
            time.sleep(0.3)
        if addr is None:
            print("head did not come up within 60s; see "
                  f"{log_path}", file=sys.stderr)
            sys.exit(1)
        _record_pid(proc.pid)
        print(f"ray_tpu_torch head up: {addr} (pid {proc.pid}, "
              f"log {log_path})")
        print("attach drivers with: ray_tpu_torch.init(address='auto')")
        return
    if not args.address:
        print("start needs --head or --address <cp_addr>",
              file=sys.stderr)
        sys.exit(2)
    # worker node daemon joining an existing (TCP) head
    from ray_tpu_torch._private.protocol import RpcClient
    cp = RpcClient(args.address)
    cp.ping()
    node_id = uuid.uuid4().bytes[:16]
    local_dir = os.path.join(tempfile.gettempdir(),
                             f"ray_tpu_torch_node_{node_id.hex()[:12]}")
    os.makedirs(os.path.join(local_dir, "sockets"), exist_ok=True)
    os.makedirs(os.path.join(local_dir, "logs"), exist_ok=True)
    shm_base = "/dev/shm" if os.path.isdir("/dev/shm") \
        else tempfile.gettempdir()
    res = {"CPU": float(args.num_cpus or os.cpu_count() or 1)}
    if args.num_gpus:
        res["GPU"] = float(args.num_gpus)
    from ray_tpu_torch._private.node_proc import build_env
    env = dict(os.environ)
    env.update(build_env(
        session_dir=local_dir, cp_addr=args.address, node_id=node_id,
        shm_root=os.path.join(shm_base,
                              f"ray_tpu_torch_node_{node_id.hex()[:12]}"),
        spill_dir=os.path.join(local_dir, "spill"), resources=res,
        use_tcp=args.address.startswith("tcp://"),
        node_ip=args.node_ip or "127.0.0.1"))
    log = open(os.path.join(local_dir, "logs", "node.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.node_proc"],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    log.close()
    _record_pid(proc.pid)
    print(f"node {node_id.hex()[:12]} joining {args.address} "
          f"(pid {proc.pid}, logs {local_dir}/logs/node.log)")


def cmd_stop(args):
    """Kill daemons started by ``ray-tpu start`` on this host, then free
    the shm objects of every dead head's session, journaled ones too:
    after ``stop`` nothing restarts a session (the journals stay)."""
    import signal

    from ray_tpu_torch._private.node import _gc_stale_sessions
    path = _pidfile()
    if not os.path.exists(path):
        print("no ray_tpu_torch daemons recorded")
    else:
        with open(path) as f:
            pids = [int(ln) for ln in f.read().split() if ln.strip()]
        stopped = 0
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
                stopped += 1
            except ProcessLookupError:
                pass
        os.unlink(path)
        print(f"stopped {stopped} daemon(s)")
    _gc_stale_sessions(reclaim_journaled=True)


def cmd_jobs(args):
    """``ray-tpu jobs ...`` against the live session's job table
    (parity: ``ray job submit/status/logs/list/stop``)."""
    import json
    if args.jobs_command == "submit":
        # submission starts a runtime in this shell, so the CLI always
        # waits for completion: exiting earlier would tear the runtime
        # (and the job's supervisor) down with it
        import ray_tpu_torch
        from ray_tpu_torch.job import JobSubmissionClient
        try:
            # a standing `ray-tpu start --head` session: attach so the
            # job runs on it and lands in the session's job table
            ray_tpu_torch.init(address="auto", ignore_reinit_error=True)
        except Exception:  # noqa: BLE001 — no live session
            ray_tpu_torch.init(ignore_reinit_error=True)
        c = JobSubmissionClient()
        jid = c.submit_job(entrypoint=args.entrypoint)
        print(jid)
        status = c.wait_until_finished(jid, timeout=args.timeout)
        print(status)
        print(c.get_job_logs(jid), end="")
        sys.exit(0 if status == "SUCCEEDED" else 1)
    client = _connect_cp()
    # read-only commands ride the CP KV of the running session
    if args.jobs_command == "list":
        for key in client.call("kv_keys", b"", "_jobs"):
            raw = client.call("kv_get", key, "_jobs")
            info = json.loads(raw.decode())
            print(f"{info['submission_id']}  {info['status']:9s}  "
                  f"{info['entrypoint'][:60]}")
    elif args.jobs_command == "status":
        raw = client.call("kv_get", args.job_id.encode(), "_jobs")
        if raw is None:
            print(f"no job {args.job_id}", file=sys.stderr)
            sys.exit(1)
        print(json.loads(raw.decode())["status"])


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray-tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("status")
    p_list = sub.add_parser("list")
    p_list.add_argument("kind", choices=["nodes", "actors", "tasks",
                                         "objects", "placement-groups"])
    p_list.add_argument("--filter", action="append", default=[],
                        help="key<op>value predicate (= != < <= > >=); "
                             "repeatable, ANDed")
    p_list.add_argument("--limit", type=int, default=None)
    p_logs = sub.add_parser("logs")
    p_logs.add_argument("name", nargs="?", default=None,
                        help="log file to tail (omit to list)")
    p_logs.add_argument("--node", default=None,
                        help="node id prefix to restrict to")
    p_logs.add_argument("--tail", type=int, default=65536,
                        help="bytes from the end to print")
    sub.add_parser("summary")
    p_tl = sub.add_parser("timeline")
    p_tl.add_argument("--output", "-o", default=None)
    sub.add_parser("memory")
    sub.add_parser("stack")
    p_mb = sub.add_parser("microbenchmark")
    p_mb.add_argument("--duration", type=float, default=2.0)
    p_db = sub.add_parser("dashboard")
    p_db.add_argument("--port", type=int, default=8265)
    p_start = sub.add_parser("start")
    p_start.add_argument("--head", action="store_true")
    p_start.add_argument("--address", default=None)
    p_start.add_argument("--num-cpus", type=float, default=None,
                         dest="num_cpus")
    p_start.add_argument("--num-gpus", type=float, default=None,
                         dest="num_gpus")
    p_start.add_argument("--tcp", action="store_true",
                         help="bind the head on TCP (multi-host)")
    p_start.add_argument("--node-ip", default=None, dest="node_ip")
    p_start.add_argument("--persist", action="store_true",
                         help="journal the control plane (restartable)")
    sub.add_parser("stop")
    p_jobs = sub.add_parser("jobs")
    jobs_sub = p_jobs.add_subparsers(dest="jobs_command", required=True)
    p_submit = jobs_sub.add_parser("submit")
    p_submit.add_argument("entrypoint")
    p_submit.add_argument("--timeout", type=float, default=600.0)
    jobs_sub.add_parser("list")
    p_jstat = jobs_sub.add_parser("status")
    p_jstat.add_argument("job_id")
    args = parser.parse_args(argv)
    {"status": cmd_status, "list": cmd_list, "summary": cmd_summary,
     "timeline": cmd_timeline, "memory": cmd_memory,
     "stack": cmd_stack, "logs": cmd_logs,
     "microbenchmark": cmd_microbenchmark,
     "dashboard": cmd_dashboard, "jobs": cmd_jobs,
     "start": cmd_start, "stop": cmd_stop}[args.command](args)


if __name__ == "__main__":
    main()
