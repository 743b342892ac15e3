"""Outer meta-training loop: step cadence, occupancy updates, eval and
save-best, resume.

Port of nerfsys_tpu/pipelines/offline/trainer.py (`meta_trainer` :20-227).
The hot work is the outer step (meta_train_step.make_train_step); this loop
moves batches, keeps the cadence and checkpoints.

Randomness: one `torch.Generator` on the step's device (the params'),
seeded from `seed`, feeds every train step, occupancy update and eval in
turn, where the reference splits a PRNG key per step; a resumed run
reseeds it from `seed`, as the reference restarts its key. `fixed_eval`
reseeds a generator of its own from `seed + 7919` at every eval, as the
reference reuses PRNGKey(seed + 7919).

Host syncs: a step's metrics are read one step late (`metric_lag=1`, the
default): `drain` reads `loss_out` and the region metrics of the previous
step after the next one has been launched, so the host never waits for
the step it has just launched. `metric_lag=0` reads each step at once.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from nerfsys_tpu_torch.utils import checkpoint as ckpt
from nerfsys_tpu_torch.utils.logging import Logger, MetricLogger
from nerfsys_tpu_torch.utils.tree import tree_leaves


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _trace(run_dir, device: torch.device):
    """A torch.profiler session writing its trace into run_dir."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(str(run_dir)))


def meta_trainer(
    *,
    params,
    opt_state,
    train_step,  # (params, opt_state, statics, batch, generator[, occ])
    eval_step,  # (params, statics, batch, generator[, occ]) -> metrics
    statics,
    train_loader,  # yields stacked episode batches (tensors on the device)
    eval_loader=None,
    config: Optional[dict] = None,
    outer_steps: int = 20000,
    eval_every: int = 200,
    save_every: int = 1000,
    print_every: int = 1,
    run_dir=None,
    logger: Optional[Logger] = None,
    seed: int = 0,
    start_step: int = 0,
    best: float = float("-inf"),
    trace_steps: int = 0,
    occ_state=None,  # stacked expert occupancy state, or None
    occ_update_fn=None,  # (occ_state, params, statics, step, generator)
    fixed_eval: bool = False,  # one pinned eval episode set + draws
    metric_lag: int = 1,  # read step metrics N steps late (0 = at once)
    eval_batches: int = 1,  # episode batches per eval point (the
    # runner passes --max_test_tasks)
):
    """Run the outer loop; returns (params, opt_state, best).

    With occupancy, each outer step ends with the occupancy update (every
    `update_interval` steps, inside `occ_update_fn`), and the train and
    eval steps render occupancy-guided once the grid is ready."""
    log = logger.log if logger else print
    meters = MetricLogger()
    device = tree_leaves(params)[0].device
    gen = _generator(device, seed)
    fixed_eval_state = None
    train_iter = iter(train_loader)
    eval_iter = iter(eval_loader) if eval_loader is not None else None

    # resume (the reference's trainer.py:27-29)
    if run_dir is not None and start_step == 0:
        restored = ckpt.is_resume(run_dir, params, opt_state)
        if restored is not None:
            params, rest_opt, state = restored
            if rest_opt is not None:
                opt_state = rest_opt
            start_step = state["step"]
            best = state.get("best", best)
            log(f"[resume] restored step {start_step}, best {best:.3f}")
            if occ_state is not None:
                occ_restored = ckpt.load_aux_state(run_dir, "occ", occ_state)
                if occ_restored is not None:
                    occ_state = occ_restored
                    log("[resume] occupancy grids restored")

    # optional device trace window: a few steady-state steps after warmup,
    # written into the run dir for TensorBoard / Perfetto
    trace_window = ()
    if trace_steps > 0 and run_dir is not None:
        t_begin = start_step + min(
            10, max(outer_steps - start_step - trace_steps, 0))
        trace_window = range(t_begin, t_begin + trace_steps)
    tracer = None

    t_last = time.perf_counter()
    pending = None  # deferred metrics read (see drain below)
    for step in range(start_step, outer_steps):
        if trace_window and step == trace_window[0]:
            tracer = _trace(run_dir, device)
            tracer.start()
            log(f"[trace] started device trace @ step {step}")
        t0 = time.perf_counter()
        batch = next(train_iter)
        t_data = time.perf_counter() - t0

        t1 = time.perf_counter()
        if occ_state is not None:
            params, opt_state, aux = train_step(params, opt_state, statics,
                                                batch, gen, occ_state)
        else:
            params, opt_state, aux = train_step(params, opt_state, statics,
                                                batch, gen)

        def drain(p):
            """Read and log one finished step's metrics; called one step
            late by default (metric_lag=1), so the read overlaps the next
            step's device work. Exact per-step times need metric_lag=0."""
            nonlocal t_last
            lo = float(p["aux"]["loss_out"])  # waits for p's step
            now = time.perf_counter()
            bt = now - t_last
            t_last = now
            st = (now - p["t1"]) if metric_lag == 0 else max(
                bt - p["t_data"], 0.0)
            meters.update(
                loss_in=float(p["aux"]["loss_in"]),
                loss_out=lo,
                psnr_out=float(p["aux"]["psnr_out"]),
                data_time=p["t_data"],
                step_time=st,
                batch_time=bt,
            )
            if logger and p["step"] % max(print_every, 1) == 0:
                logger.scalars(
                    {
                        "loss_in": p["aux"]["loss_in"],
                        "loss_out": lo,
                        "psnr_out": p["aux"]["psnr_out"],
                        "grad_norm": p["aux"].get("grad_norm", 0.0),
                        "time_data": p["t_data"],
                        "time_step": st,
                    },
                    p["step"],
                    prefix="train/",
                )
                for cid, v in enumerate(
                        p["aux"]["region_loss_out"].cpu().numpy()):
                    logger.scalar(f"train/region_{cid}/loss_out", v,
                                  p["step"])
                for cid, v in enumerate(
                        p["aux"]["region_psnr_out"].cpu().numpy()):
                    logger.scalar(f"train/region_{cid}/psnr_out", v,
                                  p["step"])
            if p["step"] % 50 == 0:
                log(f"step {p['step']}/{outer_steps}  {meters}")

        cur = {"step": step, "aux": aux, "t_data": t_data, "t1": t1}
        if metric_lag == 0:
            drain(cur)
        else:
            if pending is not None:
                drain(pending)
            pending = cur

        # occupancy EMA update cadence
        if occ_state is not None and occ_update_fn is not None:
            occ_state = occ_update_fn(occ_state, params, statics, step, gen)

        if tracer is not None and step == trace_window[-1]:
            tracer.stop()
            tracer = None
            log(f"[trace] device trace written to {run_dir}")

        # ----- periodic eval + save-best -----
        if (eval_step is not None and eval_iter is not None
                and eval_every > 0 and (step + 1) % eval_every == 0):
            n_eval = max(int(eval_batches), 1)
            if fixed_eval:
                if fixed_eval_state is None:
                    fixed_eval_state = [next(eval_iter)
                                        for _ in range(n_eval)]
                eval_set = fixed_eval_state
                g_eval = _generator(device, seed + 7919)
            else:
                eval_set = [next(eval_iter) for _ in range(n_eval)]
                g_eval = gen
            # equal-weight mean over eval batches
            evs = []
            for eval_batch in eval_set:
                if occ_state is not None:
                    evs.append(eval_step(params, statics, eval_batch, g_eval,
                                         occ_state))
                else:
                    evs.append(eval_step(params, statics, eval_batch,
                                         g_eval))
            ev = {k: np.mean([float(e[k].double().mean()) for e in evs])
                  for k in evs[0]}
            eval_psnr = float(ev["psnr_out"])
            if logger:
                logger.scalars(ev, step, prefix="eval/")
            log(f"[eval @ {step}] query psnr {eval_psnr:.3f} "
                f"(best {best:.3f})")
            if eval_psnr > best and run_dir is not None:
                best = eval_psnr
                ckpt.save_checkpoint(run_dir, "best", params, opt_state,
                                     config, step + 1, best, True)
                if occ_state is not None:
                    ckpt.save_aux_state(run_dir, "best", "occ", occ_state)
                log(f"[ckpt] new best ({best:.3f}) saved")

        if (run_dir is not None and save_every > 0
                and (step + 1) % save_every == 0):
            ckpt.save_checkpoint(run_dir, f"step{step + 1}", params,
                                 opt_state, config, step + 1, best)
            if occ_state is not None:
                ckpt.save_aux_state(run_dir, f"step{step + 1}", "occ",
                                    occ_state)
            log(f"[ckpt] step{step + 1} saved")

    if tracer is not None:
        tracer.stop()
    if pending is not None:
        drain(pending)  # the final step's metrics

    if run_dir is not None:
        ckpt.save_checkpoint(run_dir, "last", params, opt_state, config,
                             outer_steps, best)
        if occ_state is not None:
            ckpt.save_aux_state(run_dir, "last", "occ", occ_state)
        log("[ckpt] last saved")
    return params, opt_state, best
