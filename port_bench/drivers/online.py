"""Driver ``online``: a fleet of K machines learning online while it
serves, through ``TMService`` (``submit_rows`` / ``tick`` / ``serve``).

Set-up (counted in ``setup_s``): the inputs from the seed (the row pool,
the eval set, one stream a replica, the serve requests' rows), K banks
at the decision boundary drawn on the device from the seed, the service,
the rings filled to capacity, and ``warm_ticks`` ticks and two serves,
which build and load every kernel the window runs (a tick that analyses
included).

The window lasts ``--seconds``. The main thread ticks without pause and,
after each tick, offers every replica its next ``chunk`` stream rows (one
``submit_rows`` a row), so every ring stays supplied: a closed loop at
full offered load. A serving thread sends requests on an open-loop
schedule, ``serve_rate`` a second, each of ``serve_rows`` rows shared by
the whole fleet, handed at its due time to one of ``serve_clients``
client threads; a request is timed from when it was due to its
predictions on the host. The window ends with the first tick that ends
after ``--seconds`` (and a device sync); requests due in it are all
served, and one not answered a minute after the close is failed.

Correctness: the reference replays the run for a seeded sample of
``check_replicas`` replicas (their banks, acceptances, rows trained,
analyses and rollbacks over every tick) and ``check_serves`` requests,
after the system's state is freed.

With ``--trace 1`` the profiler traces ``profile_ticks`` ticks, from the
first tick that starts past ``profile_after`` of the window.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import data
import harness
import streams
from machines import boundary_banks, machine, state_dtype, tm_config

_SAMPLE = 0xC4EC


class _Clock:
    """Ticks started and done (each written by the main thread only)."""

    def __init__(self):
        self.started = 0
        self.done = 0


def run(r: harness.Run) -> None:
    import torch
    from repro_torch.core.tm import TMState
    from repro_torch.serve.service import (AdaptPolicy, ServiceConfig,
                                           TMService)
    from reference import online as ref_online

    cfg, tr = r.config, r.traffic
    dev = torch.device(r.device)
    K, chunk, cap = tr["replicas"], tr["chunk"], tr["buffer_capacity"]
    pool_x, pool_y, eval_x, eval_y = data.pool_and_eval(cfg, tr, r.seed)
    N = tr["stream_rows"]
    s_idx, s_y = streams.streams(pool_y, range(K), N, r.seed)
    rate, B = tr["serve_rate"], tr["serve_rows"]
    n_req = int(np.ceil(r.seconds * rate - 1e-9))
    req_rows = data.serve_rows(len(pool_y), n_req, B, r.seed)
    rng = np.random.default_rng(np.random.SeedSequence([r.seed, _SAMPLE]))
    sample = np.sort(rng.choice(K, min(K, tr["check_replicas"]),
                                replace=False))
    checked = set(rng.choice(n_req, min(n_req, tr["check_serves"]),
                             replace=False).tolist()) if n_req else set()

    bank = boundary_banks(cfg, K, r.seed, dev)
    init_sample = bank[torch.as_tensor(sample, device=dev)].cpu().numpy()
    svc = TMService(
        tm_config(cfg), TMState(bank),
        ServiceConfig(replicas=K, buffer_capacity=cap, chunk=chunk,
                      ingress_block=tr["ingress_block"], packed=tr["packed"],
                      s=cfg["s_online"], T=cfg["T"],
                      policy=AdaptPolicy(
                          analyze_every=tr["analyze_every"],
                          rollback_threshold=tr["rollback_threshold"]),
                      seed=r.seed),
        eval_x=eval_x, eval_y=eval_y, device=dev)
    del bank
    submits, ticks = [], []
    clock = _Clock()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def submit(t: int) -> None:
        p = t % N
        ok = svc.submit_rows(pool_x[s_idx[:, p]], s_y[:, p])
        submits.append((p, ok[sample].copy()))

    def tick():
        clock.started += 1
        rep = svc.tick()
        clock.done += 1
        ticks.append((len(submits), rep.trained[sample].copy(),
                      None if rep.accuracy is None
                      else rep.accuracy[sample].copy(),
                      rep.rolled_back[sample].copy()))
        return rep

    pos = 0
    for _ in range(cap):
        submit(pos)
        pos += 1
    for _ in range(tr["warm_ticks"]):
        tick()
        for _ in range(chunk):
            submit(pos)
            pos += 1
    for q in range(min(2, n_req)):
        svc.serve(pool_x[req_rows[q]])
    sync()
    r.setup_s = time.perf_counter() - r.t_start

    # -- the window --------------------------------------------------------
    served, failures, checked_serves = {}, [], []
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    give_up = [float("inf")]

    def one(q: int, due: float) -> None:
        if time.perf_counter() > give_up[0]:
            failures.append((q, "not served a minute after the close"))
            return
        v_lo = clock.done
        c0 = time.perf_counter()
        try:
            preds = svc.serve(pool_x[req_rows[q]])
        except Exception as e:  # a failed request is counted, not fatal
            failures.append((q, repr(e)))
            return
        c1 = time.perf_counter()
        r.span("serve", c0, c1)
        served[q] = (c1 - due, c1 - c0)
        if q in checked:
            checked_serves.append((req_rows[q], v_lo, clock.started,
                                   preds[sample].astype(np.int8)))

    def serve_loop(pool) -> None:
        """Issue request q at its due time, whatever became of the
        earlier ones (an open loop of independent clients)."""
        for q in range(n_req):
            due = t0 + q / rate
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            pool.submit(one, q, due)

    clients = ThreadPoolExecutor(max_workers=tr["serve_clients"],
                                 thread_name_prefix="client")
    th = threading.Thread(target=serve_loop, args=(clients,), name="serve",
                          daemon=True)
    th.start()
    prof, n_prof = None, 0
    prof_from = t0 + tr["profile_after"] * r.seconds
    while time.perf_counter() < deadline:
        a = time.perf_counter()
        if (r.trace and dev.type == "cuda" and prof is None and n_prof == 0
                and a >= prof_from):
            sync()
            prof = harness.start_profile(r, a)
            a = time.perf_counter()
        rep = tick()
        b = time.perf_counter()
        r.span("tick", a, b, steps=int(rep.trained.max(initial=0)),
               work=int(rep.trained.sum()), profiled=prof is not None)
        for _ in range(chunk):
            submit(pos)
            pos += 1
        r.span("submit", b, time.perf_counter())
        if prof is not None:
            n_prof += 1
            if n_prof >= tr["profile_ticks"]:
                harness.stop_profile(r, prof)
                prof = None
    sync()
    t_close = time.perf_counter()
    if prof is not None:
        harness.stop_profile(r, prof)
    r.window = (t0, t_close)
    give_up[0] = t_close + 60.0
    th.join()
    clients.shutdown(wait=True)

    r.attempted = n_req
    r.failed = len(failures)
    for q in sorted(served):
        r.serve_latency_ms.append(served[q][0] * 1e3)
        r.serve_call_ms.append(served[q][1] * 1e3)
    m = machine(cfg)
    C, J, L = m.shape
    r.shapes = dict(R=K, D=K, C=C, J=J, L=L,
                    state_bytes=state_dtype(cfg).itemsize)
    final = svc.ss.tm.ta_state[torch.as_tensor(sample, device=dev)]
    final = final.cpu().numpy()
    if dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    lat = [served[q][0] * 1e3 for q in sorted(served)]
    quarters = np.array_split(np.asarray(lat), 4) if lat else []
    r.info.update(window_ticks=len(r.spans.get("tick", [])),
                  latency_ms_median_by_quarter=[
                      round(float(np.median(x)), 1) for x in quarters
                      if len(x)],
                  serves_answered=len(served),
                  serve_failures=failures[:3])
    del svc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    traj = ref_online.Trajectory(
        machine=m, s=cfg["s_online"], T=cfg["T"], chunk=chunk, capacity=cap,
        analyze_every=tr["analyze_every"],
        rollback_threshold=tr["rollback_threshold"], service_seed=r.seed,
        sample=sample, init_bank=init_sample, pool_x=pool_x,
        stream_idx=s_idx[sample], stream_y=s_y[sample], eval_x=eval_x,
        eval_y=eval_y, submits=submits, ticks=ticks,
        serves=checked_serves, final_bank=final)
    judge(r, traj, dev)


def judge(r: harness.Run, traj, dev) -> None:
    """Replay ``traj`` with the reference and record each count of
    disagreeing answers as a check with limit 0 (under ``--control``, the
    reference with bfloat16 uniforms stands in for the system)."""
    import torch
    from reference import online as ref_online

    t = time.perf_counter()
    if r.control == "bf16":
        _, ans = ref_online.replay(traj, dev, torch.bfloat16, judge=False)
        traj = dataclasses.replace(traj, submits=ans.submits,
                                   ticks=ans.ticks, serves=ans.serves,
                                   final_bank=ans.final_bank)
    bad, _ = ref_online.replay(traj, dev)
    r.info["reference_s"] = round(time.perf_counter() - t, 3)
    r.info["checked"] = (f"{len(traj.sample)} replicas, {len(traj.ticks)} "
                         f"ticks, {len(traj.serves)} serves")
    for name, v in bad.items():
        r.check(f"{name}_differ", v, 0)
    r.check("serves_failed", r.failed, 0)
