"""What the traffic drivers (``vobench/drivers/<driver>.py``) share: the
inputs of a mix, a batch of lanes handed to one batched call after another
(``Batch``), sequences fed a frame at a time to streaming sessions
(``Session``), and the control of each (the reference in the program's
place, ``*_control``).

A mix file (``vobench/traffic/<mix>.json``) names its ``driver`` and its
parameters.  A driver module exposes ``make(config, traffic, seed, device)``,
which makes the inputs from the seed and warms up every shape (set-up), and
returns an object with ``t_inputs``, ``t_warm``, ``window(seconds)``,
``sample(n)`` (what the check reads, kept from the window) and ``traced()``
(one profiled slice of whole units); ``numbers(payload, config, device)``,
the check's numbers of what ``sample`` kept; and ``control(config, traffic,
seed, precision, device)``, the same numbers of the control.  A new kind of
traffic is a new driver module, which may import of the program what it
needs; the drivers here use ``vobench/program.py``.
"""

from __future__ import annotations

import contextlib
import math
import random
import time

import numpy as np
import torch

from vobench import check, gen, stats
from vobench.trace import profiled, span

now = time.perf_counter


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def inputs(config: dict, n: int, noise_px: float, seed: int) -> dict:
    """n problems of the configuration's recorded sequence, each with its
    own ``noise_px`` of pixel noise drawn from the run's seed."""
    return gen.problems(gen.sequence(config), n, noise_px, gen.problem_seed(seed, 1 << 20))


def batch_inputs(config: dict, traffic: dict, seed: int) -> dict:
    return inputs(config, traffic["lanes"], traffic["lane_noise_px"], seed)


def session_inputs(config: dict, traffic: dict, seed: int) -> dict:
    return inputs(config, traffic["sequences"], traffic["lane_noise_px"], seed)


def _finite_lanes(poses) -> int:
    """Problems whose poses are not all finite."""
    return int((~torch.isfinite(poses).flatten(1).all(1)).sum())


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def _boot(T_boot, frames: dict, draws) -> dict:
    """What ``check.boot_numbers`` reads: the program's bootstrap poses
    (P, 4, 4), frames 0 and 1 of each problem and its RANSAC draw."""
    return dict(T_boot=T_boot, f0={k: v[:, 0] for k, v in frames.items()},
                f1={k: v[:, 1] for k, v in frames.items()}, draws=draws)


class Batch:
    """``lanes`` problems of the configuration (each its own noise) handed
    to one ``run_batch`` call after another; a unit is a call, its work
    lanes x frames."""

    def __init__(self, config, traffic, seed, device, prog):
        self.config, self.traffic, self.seed, self.device, self.prog = (
            config, traffic, seed, device, prog)
        self.cfg = prog.engine_config(config)
        t = now()
        self.host = batch_inputs(config, traffic, seed)
        self.inputs = gen.to_device(self.host, device)
        self.B, self.F = self.inputs["valid"].shape[:2]
        self.rseed = gen.problem_seed(seed, 0)
        sync(device)
        self.t_inputs, t = now() - t, now()
        for _ in range(2):  # the capture, then a call as the window makes it
            self.prog.run_batch(self.inputs, self.cfg, self.rseed)
            sync(device)
        self.t_warm = now() - t

    def window(self, seconds: float) -> dict:
        rng = random.Random(self.seed)
        calls, failed, kept, walls = 0, 0, None, []
        t0 = t_last = now()
        while t_last - t0 < seconds:
            out, _ = self.prog.run_batch(self.inputs, self.cfg, self.rseed)
            sync(self.device)
            failed += _finite_lanes(out["poses"])
            walls.append(now() - t_last)
            t_last = now()
            calls += 1
            if rng.random() < 1.0 / calls:  # a call drawn uniformly from the seed
                kept = {k: v.clone() for k, v in out.items()}
        self.kept = kept
        return dict(attempted=calls * self.B, failed=failed, latencies=walls,
                    metrics=dict(batch_frames_per_s=stats.rate(calls * self.B * self.F, t0,
                                                               t_last)))

    def sample(self, n: int) -> dict:
        """n lanes of the kept call drawn from the seed, for the steps; every
        lane of it, for the bootstrap."""
        lanes = sorted(random.Random(self.seed + 1).sample(range(self.B), min(n, self.B)))
        idx = torch.tensor(lanes)
        ans = {k: v.detach().cpu() for k, v in self.kept.items()}
        host = {k: torch.as_tensor(np.array(v)) for k, v in self.host.items()}
        H, N = self.cfg.ransac.num_hypotheses, self.cfg.max_obs
        draws = check.uniforms(self.rseed, (self.B, H, N))
        return dict(vo=({k: v[idx] for k, v in ans.items()}, {k: v[idx] for k, v in host.items()},
                        draws[idx]),
                    boot=_boot(ans["T_boot"], host, draws))

    def traced(self) -> dict:
        """One call timed alone (synchronised, untraced), then the same call
        under the profiler with the program's bootstrap and scan in spans;
        then, outside the slice, the synchronised bootstrap call timed three
        times.  The context keeps the traced call's answers and logs, its
        inputs and the program's configuration for the readers."""
        t = now()
        self.prog.run_batch(self.inputs, self.cfg, self.rseed)
        sync(self.device)
        plain_s = now() - t
        got = {}
        with self.prog.spans(span), profiled(got):
            out, logs = self.prog.run_batch(self.inputs, self.cfg, self.rseed)
        boots = []
        for _ in range(3):
            t = now()
            self.prog.bootstrap_call(self.inputs, self.cfg, self.rseed)
            sync(self.device)
            boots.append(now() - t)
        return dict(trace=got["trace"], steps=self.F - 1, plain_s=plain_s,
                    host=dict(bootstrap_s=sum(boots) / 3), out=out, logs=logs,
                    inputs=self.inputs, cfg=self.cfg)


class Session:
    """``sequences`` problems fed, one after another, to a new streaming
    session each (``make(cfg, seed, n_frames)``, the program's session
    type), a frame at a time in a closed loop: the next frame is handed
    over once the last pose is on the host.  A unit is a pose; its latency
    runs from the hand-over to the pose on the host (the first pose of a
    sequence also waits for the session's start)."""

    def __init__(self, config, traffic, seed, device, prog, make):
        self.config, self.traffic, self.seed, self.device, self.prog = (
            config, traffic, seed, device, prog)
        self.cfg = prog.engine_config(config)
        t = now()
        self.host = session_inputs(config, traffic, seed)
        self.inputs = gen.to_device(self.host, device)
        self.S, self.F = self.inputs["valid"].shape[:2]
        self.make = make
        sync(device)
        self.t_inputs, t = now() - t, now()
        self.due, self.boots = [], []
        for j in range(2):  # the captures, then a sequence as the window runs it
            self.sequence(-1 - j, [], keep=False)
        self.due, self.boots = [], []
        self.t_warm = now() - t

    def sequence(self, j: int, lat: list, keep: bool, spans: bool = False, stop=None):
        """Feed sequence j (its frames are pool entry j mod S) to a new
        session; append each pose's latency to ``lat`` and, in the window
        (``stop``), (j, the bootstrap's pose) to ``self.boots``.  Returns (what the check reads,
        or None; poses that were not finite).  A session that the check
        reads through copies of its state (``snapshot``) is copied after
        its start and around the mix's ``check_steps`` steps drawn from the
        seed, outside every pose's latency."""
        b = j % self.S
        s = self.make(self.cfg, gen.problem_seed(self.seed, j), self.F)
        fa = lambda i: self.prog.frame_at(self.inputs, b, i)
        cm = span if spans else (lambda name: contextlib.nullcontext())
        snap = keep and hasattr(s, "snapshot")
        picks = (set(random.Random(gen.problem_seed(self.seed, j)).sample(
            range(2, self.F), self.traffic["check_steps"])) if snap else ())
        rec = dict(steps=[])
        poses, failed, cut = [], 0, False
        t = now()
        with cm("start"):
            s.start(fa(0), fa(1))
        if snap:
            rec["boot"] = s.snapshot()
        for i in range(1, self.F):
            if i in picks:
                before = s.snapshot()
            if i > 1:
                t = now()
            with cm("step"):
                pose = s.step(fa(i))
                host = pose.cpu()
            self.t_done = now()
            lat.append(self.t_done - t)
            self.due.append(s.ba_due(i))
            failed += int(not bool(torch.isfinite(host).all()))
            if keep:
                poses.append(pose)
            if i in picks:
                rec["steps"].append((i, before, s.snapshot()))
            if stop is not None and self.t_done >= stop:
                cut = True
                break
        if stop is not None:  # a sequence of the window
            self.boots.append((j, s.diag["T_boot"].clone()))
        if not keep or cut:
            return None, failed
        if snap:
            rec.update(T_boot=s.diag["T_boot"], j=j)
            return rec, failed
        return s.answers(poses), failed

    def window(self, seconds: float) -> dict:
        rng = random.Random(self.seed)
        m = self.traffic["check_problems"]
        lat, kept, failed = [], [], 0
        t0 = now()
        stop = t0 + seconds
        j = 0
        while now() < stop:
            slot = len(kept) if len(kept) < m else rng.randrange(j + 1)
            ans, f = self.sequence(j, lat, slot < m, stop=stop)
            failed += f
            if ans is not None:
                item = (j, to_cpu(ans))
                if slot < len(kept):
                    kept[slot] = item
                else:
                    kept.append(item)
            j += 1
        self.kept = kept
        return dict(attempted=len(lat), failed=failed, metrics=dict(
            frames_per_s=stats.rate(len(lat), t0, self.t_done),
            frame_latency_p95_ms=1e3 * stats.percentile(lat, 95)),
            latencies=lat, due=list(self.due))

    def _pool(self, js) -> dict:
        return {k: torch.as_tensor(np.array(v[[j % self.S for j in js]]))
                for k, v in self.host.items()}

    def _draws(self, js):
        H, N = self.cfg.ransac.num_hypotheses, self.cfg.max_obs
        return torch.stack([check.uniforms(gen.problem_seed(self.seed, j), (H, N)) for j in js])

    def sample(self, n: int) -> dict:
        """The kept sequences (``vo``: their answers, frames and draws;
        ``slam``: their copies) and the bootstrap of every sequence the
        window started (``boot``)."""
        js = [j for j, _ in self.boots]
        out = dict(boot=_boot(torch.stack([to_cpu(T) for _, T in self.boots]), self._pool(js),
                              self._draws(js)) if js else None)
        if not self.kept:
            return out
        js = [j for j, _ in self.kept][:n]
        frames, draws = self._pool(js), self._draws(js)
        items = [a for _, a in self.kept[:n]]
        if "steps" in items[0]:
            out["slam"] = [dict(a, frames={k: v[i] for k, v in frames.items()}, draws=draws[i])
                           for i, a in enumerate(items)]
        else:
            out["vo"] = ({k: torch.cat([a[k] for a in items]) for k in items[0]}, frames, draws)
        return out

    def traced(self) -> dict:
        """The mix's ``trace_units`` sequences timed alone (untraced), then
        the same sequences under the profiler, each start and step in a
        span."""
        n = self.traffic["trace_units"]
        t = now()
        for j in range(n):
            self.sequence(10**6 + j, [], keep=False)
        sync(self.device)
        plain_s = now() - t
        got = {}
        with self.prog.spans(span), profiled(got):
            for j in range(n):
                self.sequence(10**6 + j, [], keep=False, spans=True)
        return dict(trace=got["trace"], steps=n * (self.F - 1), plain_s=plain_s, host={})


def numbers(payload: dict, config: dict, device) -> dict:
    """The check's numbers of what a driver's ``sample`` kept: the steps
    (``vo`` or ``slam``) and the bootstrap (``boot``); a window that
    completed nothing to check fails it."""
    nums = {}
    if payload.get("boot") is not None:
        nums.update(check.boot_numbers(**payload["boot"], config=config, device=device))
    if "slam" in payload:
        nums.update(check.slam_numbers(payload["slam"], config, device=device))
    elif "vo" in payload:
        nums.update(check.numbers(*payload["vo"], config, device=device))
    else:
        nums["state_faults"] = math.inf
    return nums


# -- the controls: the reference in the program's place -----------------------
def _lowered(precision: str):
    """Run the reference in the control's precision inside the block."""
    from vobench.reference import vo as ref

    @contextlib.contextmanager
    def block():
        if precision == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif precision == "tf32-emulated":
            ref.set_lower("tf32")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            ref.set_lower(None)

    return block()


def vo_control(config, traffic, seed, precision, device, batch: bool) -> dict:
    """The tracker's control: the reference run closed loop over the whole
    batch (``batch``) or the mix's first ``check_problems`` sequences, each
    with the draw the program's run gives it, then judged as a run is."""
    from vobench.reference import run as ref_run

    e = config["engine"]
    H, N, C = e["ransac"]["num_hypotheses"], e["max_obs"], e["map_capacity"]
    n = traffic["check_problems"]
    if batch:
        host = batch_inputs(config, traffic, seed)
        B = host["valid"].shape[0]
        draws = check.uniforms(gen.problem_seed(seed, 0), (B, H, N))
        lanes = sorted(random.Random(seed + 1).sample(range(B), min(n, B)))
    else:
        host = session_inputs(config, traffic, seed)
        lanes = list(range(min(n, host["valid"].shape[0])))
        draws = torch.stack([check.uniforms(gen.problem_seed(seed, j), (H, N)) for j in lanes])
        host = {k: v[lanes] for k, v in host.items()}
    x = {k: torch.as_tensor(np.array(v)) for k, v in host.items()}
    cam = check.camera(config, device)
    cfg = check.ref_config(config)
    with _lowered(precision):
        ans = ref_run.run(gen.to_device(host, device), draws.to(device), cam, cfg, C)
    ans = {k: v.cpu() for k, v in ans.items()}
    pick = torch.tensor(lanes if batch else list(range(len(lanes))))
    nums = numbers(dict(vo=({k: v[pick] for k, v in ans.items()},
                            {k: v[pick] for k, v in x.items()}, draws[pick]),
                        boot=_boot(ans["T_boot"], x, draws)), config, device)
    return nums


def slam_control(config, traffic, seed, precision, device) -> dict:
    """The SLAM control: the reference's SLAM run closed loop over the mix's
    first ``check_problems`` sequences, copied around the same number of
    seeded steps as a run copies, then judged as a run is."""
    from vobench.reference import run as ref_run

    e = config["engine"]
    H, N, C = e["ransac"]["num_hypotheses"], e["max_obs"], e["map_capacity"]
    host = session_inputs(config, traffic, seed)
    cam = check.camera(config, device)
    cfg, ba = check.ref_config(config), check.ba_config(config)
    samples = []
    js = list(range(min(traffic["check_problems"], host["valid"].shape[0])))
    for j in js:
        frames = {k: torch.as_tensor(np.array(v[j])) for k, v in host.items()}
        F = frames["valid"].shape[0]
        picks = set(random.Random(gen.problem_seed(seed, j)).sample(range(2, F),
                                                                     traffic["check_steps"]))
        draws = check.uniforms(gen.problem_seed(seed, j), (H, N))
        with _lowered(precision):
            smp = ref_run.run_slam({k: v.to(device) for k, v in frames.items()}, draws, cam,
                                   cfg, ba, C, picks)
        samples.append(dict(to_cpu(smp), frames=frames, draws=draws))
    x = {k: torch.stack([s["frames"][k] for s in samples]) for k in samples[0]["frames"]}
    boot = _boot(torch.stack([s["T_boot"] for s in samples]), x,
                 torch.stack([s["draws"] for s in samples]))
    return numbers(dict(slam=samples, boot=boot), config, device)
