"""Elastic training loop: controller + kill-free reconfiguration
(counterpart of ``repro/train/elastic.py``; paper §4.4).

The paper's framework keeps workers alive across availability changes:
they tear down communicators, repartition the model, and continue.  The
equivalent here is a *reshard*: the live params and AdamW state are
gathered from the old mesh and laid out on the new one's specs, and the
step is made anew for the new plan — no process restart, no rollback
(rollback to the latest async checkpoint only happens when devices are
*lost* with state on them, i.e. a failure rather than a planned change).

The controller is in-process and drives ('data', 'model') meshes over
prefixes of ``devices`` (``dist/mesh.py``: one process runs every position
in lockstep; a list may repeat a card, so a (2, 2) plan runs on one
H100).  The step is ``train_step.jit_train_step`` on that mesh, params
and moments ``placement.Sharded`` trees laid out by ``param_specs(decls,
cfg.sharding, mesh)``, the step replicated.  The step is made with
``graphed=None`` (as the reference's trainer takes the jitted step): a
CUDA graph where the mesh's positions share one card, eager elsewhere.
A graph is bound to the storage of the params and state it first ran
on, so wherever they are replaced (a kill-free reshard, a rollback,
``restore_from_checkpoint``) the trainer makes a new step, which captures
anew; ``captures`` lists each capture's step and seconds, and a
reconfiguration's row takes the seconds of the capture its own new step
made (``capture_s``, None until that step captures).

Straggler mitigation: per-step wall times feed a median detector; a step
slower than ``factor``x the running median flags the event to the
controller, which (like Sailor) re-invokes the planner — here recorded and
surfaced in metrics so tests and callers can assert on it.

Telemetry (``telemetry=`` a ``telemetry.TelemetryBus``): after each step
the loop emits ``step_time``, ``data_stall`` (the data fetch's seconds)
and a heartbeat, then closes the step with ``end_step``, at ``clock()``
when a caller (``manager.Controller``) pins it and at the wall clock
otherwise, as the reference's ``_emit_telemetry`` does.

Where the reference differs: ``devices=`` (default every CUDA device;
raises without a card) and ``build(n, init_seed=)`` in place of
``init_key`` (``model.init``'s seeded weights).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import Mesh, data_model_mesh
from repro_torch.dist.sharding import P, param_specs
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


@dataclasses.dataclass(frozen=True)
class RuntimePlan:
    """What the launcher needs from a planner decision for one jit program."""
    n_devices: int
    dp: int
    tp: int
    num_microbatches: int = 1
    # per-microbatch gradient weights (len == num_microbatches, summing
    # to 1) from an adaptive plan's BatchAssignment; None = uniform
    micro_weights: Optional[Tuple[float, ...]] = None

    def mesh_shape(self) -> Tuple[int, int]:
        assert self.dp * self.tp == self.n_devices, self
        return (self.dp, self.tp)


class StragglerDetector:
    def __init__(self, factor: float = 3.0, window: int = 20,
                 warmup: int = 5):
        self.factor = factor
        self.times: List[float] = []
        self.window = window
        self.warmup = warmup
        self.events: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Flag ``step`` if ``dt`` exceeds ``factor``x the median of the
        last ``window`` completed steps (the history excludes ``dt``
        itself, else a slow step would drag its own baseline up)."""
        hist = self.times[-self.window:]
        self.times.append(dt)
        del self.times[:-self.window]        # bound memory for long runs
        if len(hist) >= self.warmup and \
                dt > self.factor * float(np.median(hist)):
            self.events.append(step)
            return True
        return False


def _reshard(x: pm.Sharded, spec, mesh: Mesh) -> pm.Sharded:
    """``x`` gathered to ``mesh``'s first device, then laid out on it."""
    return pm.shard(pm.unshard(x, mesh.device_list[0]), spec, mesh)


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                 data_cfg: data_lib.DataConfig, workdir: str,
                 checkpoint_every: int = 20,
                 plan_fn: Optional[Callable[[int], RuntimePlan]] = None,
                 telemetry=None, devices: Optional[Sequence] = None):
        if devices is None:
            resolve_device(None)            # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.data = data_lib.SyntheticDataset(cfg, data_cfg)
        self.ckpt = ckpt_lib.CheckpointManager(workdir)
        self.checkpoint_every = checkpoint_every
        self.plan_fn = plan_fn or self._default_plan
        self.detector = StragglerDetector()
        # optional telemetry.TelemetryBus: the step loop then emits
        # step_time / data_stall / heartbeat samples and closes each step
        # with end_step, feeding the control plane's online detectors
        # alongside (not instead of) the in-loop StragglerDetector.
        self.telemetry = telemetry
        # telemetry timestamps come from this clock; the manager's
        # controller pins it to its sim clock so bus events interleave
        # time-ordered with feed events (None = wall clock).
        self.clock: Optional[Callable[[], float]] = None
        self.log: List[Dict[str, Any]] = []
        self.reconfigs: List[Dict[str, Any]] = []
        # one row a graph captured: the step it captured at, the devices
        # and the capture's host seconds
        self.captures: List[Dict[str, Any]] = []
        # the reconfiguration whose new step is the current one, if any
        self._step_reconfig: Optional[Dict[str, Any]] = None

        self.mesh: Optional[Mesh] = None
        self.plan: Optional[RuntimePlan] = None
        self.step_fn = None
        self.params = None
        self.opt_state = None
        self.step = 0

    # --- planning ------------------------------------------------------------
    def _default_plan(self, n_devices: int) -> RuntimePlan:
        """Greedy: all devices data-parallel (planner integration replaces
        this in launch/train.py --plan)."""
        return RuntimePlan(n_devices=n_devices, dp=n_devices, tp=1,
                           num_microbatches=self.data_cfg.num_microbatches)

    # --- (re)build -------------------------------------------------------------
    def build(self, n_devices: int, init_seed: Optional[int] = None):
        """Initial build or kill-free rebuild onto ``devices[:n_devices]``.
        The first build draws ``model.init(cfg, init_seed or 0)`` on the
        first device and lays it out; a rebuild reshards the live params,
        ``m``, ``v`` and step onto the new mesh (nothing recomputed)."""
        if n_devices > len(self.devices):
            raise ValueError(f"build({n_devices}): the trainer has "
                             f"{len(self.devices)} devices")
        devices = self.devices[:n_devices]
        plan = self.plan_fn(n_devices)
        mesh = data_model_mesh(*plan.mesh_shape(), devices)
        specs = param_specs(model_lib.decls(self.cfg), self.cfg.sharding,
                            mesh)
        if self.params is None:
            full = model_lib.init(self.cfg, 0 if init_seed is None
                                  else init_seed, device=devices[0])
            self.params = pm.shard_tree(full, specs, mesh)
            del full
            self.opt_state = opt_lib.init_sharded_state(self.params)
        else:
            # kill-free: reshard live state onto the new mesh
            flat = dict(pm.tree_items(specs))

            def move(tree):
                return pm.tree_map(
                    lambda path, x: _reshard(x, flat[path], mesh), tree)

            self.params = move(self.params)
            self.opt_state = {"m": move(self.opt_state["m"]),
                              "v": move(self.opt_state["v"]),
                              "step": _reshard(self.opt_state["step"], P(),
                                               mesh)}
        self.mesh, self.plan = mesh, plan
        self._new_step()

    def _new_step(self) -> None:
        """The step for the current mesh and plan, made anew: a graphed
        one binds to the params and state of its first call."""
        plan = self.plan
        self.step_fn = ts_lib.jit_train_step(
            self.cfg, self.opt_cfg, self.mesh, plan.num_microbatches,
            self.data_cfg.micro_batch, micro_weights=plan.micro_weights)
        self._step_reconfig = None

    # --- failure path -------------------------------------------------------------
    def restore_from_checkpoint(self, n_devices: int):
        """Failure recovery: rebuild mesh, load latest checkpoint."""
        self.params = None
        self.opt_state = None
        self.build(n_devices)
        template = {"params": self.params, "opt": self.opt_state}
        try:
            state, step = self.ckpt.restore(template, shardings=template)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = step
            self._new_step()        # new tensors: a graph binds anew
        except FileNotFoundError:
            self.step = 0          # cold start

    # --- events ----------------------------------------------------------------------
    def on_availability_change(self, n_devices: int, failure: bool = False):
        t0 = time.perf_counter()
        step_at_event = self.step
        if failure:
            self.restore_from_checkpoint(n_devices)
            kind = "rollback"
        else:
            self.build(n_devices)
            kind = "kill-free"
        # step times change scale with the device set; a stale median would
        # flag every post-reconfig step as a straggler.
        self.detector.times.clear()
        self.reconfigs.append({
            "step": step_at_event, "resumed_at": self.step,
            "n_devices": n_devices, "kind": kind,
            "reconfig_s": time.perf_counter() - t0, "capture_s": None})
        self._step_reconfig = self.reconfigs[-1]

    # --- telemetry -------------------------------------------------------------------
    def _emit_telemetry(self, step_s: float, data_s: float) -> None:
        """One step's samples onto the attached bus (no-op when detached)."""
        if self.telemetry is None:
            return
        from repro_torch.telemetry.bus import Sample, wall_clock
        t = self.clock() if self.clock is not None else wall_clock()
        emit = self.telemetry.emit
        emit(Sample("step_time", (), t, self.step, step_s))
        emit(Sample("data_stall", (), t, self.step, data_s))
        emit(Sample("heartbeat", (0, 0), t, self.step, 1.0,
                    {"zone": "local", "acc_type": "host",
                     "chips": self.plan.n_devices if self.plan else 0}))
        self.telemetry.end_step(self.step, t)

    # --- training -------------------------------------------------------------------
    def train(self, num_steps: int,
              events: Sequence[Tuple[int, int, bool]] = ()) -> List[Dict]:
        """Run ``num_steps``; ``events`` = (at_step, new_n_devices, failure).

        Multiple events scheduled at the same step are applied in the order
        given.  ``time_s`` is the host wall from the step's call to its
        loss read back (which waits for the device)."""
        ev: Dict[int, List[Tuple[int, bool]]] = {}
        for s, n, f in events:
            ev.setdefault(s, []).append((n, f))
        if self.mesh is None:
            self.build(len(self.devices))
        end = self.step + num_steps
        while self.step < end:
            if self.step in ev:
                for n, failure in ev.pop(self.step):
                    self.on_availability_change(n, failure)
            t_data = time.perf_counter()
            batch = self.data.batch(self.step)
            t_data = time.perf_counter() - t_data      # input-pipeline wait
            captured = self.step_fn.capture_seconds
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if captured is None and self.step_fn.capture_seconds is not None:
                self.captures.append({
                    "step": self.step, "n_devices": self.plan.n_devices,
                    "capture_s": self.step_fn.capture_seconds})
                if self._step_reconfig is not None:
                    self._step_reconfig["capture_s"] = \
                        self.step_fn.capture_seconds
            straggler = self.detector.observe(self.step, dt)
            self.log.append({"step": self.step, "time_s": dt, "loss": loss,
                             "n_devices": self.plan.n_devices,
                             "straggler_flag": straggler})
            self._emit_telemetry(dt, t_data)
            self.step += 1
            if self.step % self.checkpoint_every == 0:
                self.ckpt.save(self.step, {
                    "params": self.params, "opt": self.opt_state})
        # saves stay in flight: joining here would put checkpoint I/O on
        # the critical path of callers stepping one step at a time (the
        # manager.Controller loop).  save()/restore() already serialize
        # against the in-flight write; call ckpt.wait() for durability.
        return self.log
