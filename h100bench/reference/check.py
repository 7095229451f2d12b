"""The comparison that decides ``correct``.

For each sampled answer the reference works out again, from the same
document and the same seeded inputs, the embeddings (float32 forward of
the configuration's encoder, or float64 hashed bag-of-words), mu and beta,
and the objective's bounds, then judges what the program returned and
what its solver was handed (``h100bench/capture.py``):

* ``bad_answers``: answers that do not select exactly min(m, N) sentences,
  whose selected texts are not the items the selection marks, or whose
  objective is not finite.  Exact: limit 0.
* ``objective_gap``: the largest |objective the program reports - the
  reference's objective of the same selection|, over the reference's span
  (max - min over selections of m): the encoder, mu and beta and the
  objective's arithmetic end to end.
* ``mu_beta_gap``: the largest |mu - mu_ref|, |beta - beta_ref| of the
  request's problem as the engine formed it: the start of the solver's
  side, by itself.
* ``formulation_gap``: the largest gap of each formulation the rounding
  took from the reference's (``reference/formulation.py``) built from that
  formulation's own mu and beta, over the reference's largest magnitude.
  It follows the program's state (its mu and beta, each window's
  restriction); ``mu_beta_gap`` and ``window_faults`` check that state.
* ``rounding_faults``: rounded instances that are not a rounding of their
  formulation into [-R, R] (integers, in range, within one step of the one
  scale, J symmetric with a zero diagonal), formulations whose iterations
  were all rounded alike (stochastic rounding draws anew each iteration),
  and instances submitted with no formulation.  Exact: limit 0.
* ``energy_faults``: solver answers whose energy is not the energy of
  their spins (+-1) on the instance they were given, or that never came.
  Exact: limit 0.
* ``window_faults``: sentences of the request (distinct ones: a document
  may repeat a sentence) in no window the solver saw, and windows that are
  not the request's problem restricted to sentences in document order.
  Exact: limit 0.

``objective_gap``, ``mu_beta_gap`` and ``formulation_gap`` have their limits
in ``h100bench/limits/<config>.json``, set from the program's readings and
the control's.  ``quality_gap``, 1 - the mean normalized objective (Eq. 13,
under the reference's bounds) of the answers, is printed beside them and not
compared: nothing the program can get wrong separates from its sound runs
by it (``PERF.md``).
"""

from __future__ import annotations

import bisect
import math

import numpy as np

from h100bench.reference import formulation, scores


def judge_answer(sentences, m: int, lam: float, mu, beta, answer: dict) -> dict:
    """The numbers of one answer.  ``answer`` holds the program's
    ``selection`` (0/1 over the items), ``selected`` (texts) and
    ``objective``."""
    n = len(sentences)
    sel = np.asarray(answer["selection"])
    bad = (sel.shape != (n,) or not np.isin(sel, (0, 1)).all()
           or int(sel.sum()) != min(m, n)
           or list(answer["selected"]) != [sentences[i] for i in np.nonzero(sel)[0]]
           or not math.isfinite(float(answer["objective"])))
    hi, lo, exact = scores.bounds(mu, beta, lam, m)
    span = max(hi - lo, 1e-12)
    if sel.shape != (n,):
        return {"bad": True, "objective_gap": math.inf, "quality_gap": math.inf,
                "exact_bounds": exact}
    ref_obj = scores.objective(mu, beta, lam, sel)
    gap = abs(float(answer["objective"]) - ref_obj) / span
    quality = max(0.0, 1.0 - (ref_obj - lo) / span)
    return {"bad": bool(bad), "objective_gap": gap if math.isfinite(gap) else math.inf,
            "quality_gap": quality, "exact_bounds": exact}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def judge_solver(log, mu_ref, beta_ref, int_range: int) -> dict:
    """The numbers of what the solver was handed for one request, from its
    ``capture.RequestLog`` (None: nothing was captured)."""
    n = len(mu_ref)
    out = {"mu_beta_gap": math.inf, "formulation_gap": 0.0, "rounding_faults": 0,
           "energy_faults": 0, "window_faults": n}
    if log is None or log.mu is None:
        return out
    mu, beta = _np(log.mu).astype(np.float64), _np(log.beta).astype(np.float64)
    if mu.shape != (n,) or beta.shape != (n, n):
        return out
    out["mu_beta_gap"] = float(max(np.abs(mu - mu_ref).max(initial=0.0),
                                   np.abs(beta - beta_ref).max(initial=0.0)))
    where: dict[float, list[int]] = {}
    for i, v in enumerate(mu.tolist()):
        where.setdefault(v, []).append(i)
    covered, bad_windows = set(), 0
    out["rounding_faults"] = log.unformulated
    for f in log.formulations:
        f_mu, f_beta = _np(f.mu).astype(np.float64), _np(f.beta).astype(np.float64)
        idx = _restriction(where, f_mu.tolist())
        if idx is None or not np.array_equal(beta[np.ix_(idx, idx)], f_beta):
            bad_windows += 1
        else:
            covered.update(f_mu.tolist())
        h_ref, j_ref = formulation.improved_ising(f_mu, f_beta, f.m, f.lam, f.gamma)
        h, j = _np(f.h), _np(f.j)
        out["formulation_gap"] = max(out["formulation_gap"],
                                     formulation.formulation_gap(h, j, h_ref, j_ref))
        rounded = [(_np(q.h), _np(q.j)) for q in f.instances]
        out["rounding_faults"] += sum(
            not formulation.rounding_ok(h, j, qh, qj, int_range) for qh, qj in rounded)
        if len(rounded) > 1 and all(np.array_equal(rounded[0][1], qj) and
                                    np.array_equal(rounded[0][0], qh) for qh, qj in rounded):
            out["rounding_faults"] += 1
        for q, (qh, qj) in zip(f.instances, rounded):
            if q.spins is None:
                out["energy_faults"] += 1
                continue
            s = _np(q.spins).astype(np.float64).reshape(-1, len(qh))[0]
            e = float(_np(q.energy).reshape(-1)[0])
            e_ref = formulation.energy(qh, qj, s)
            if not np.isin(s, (-1.0, 1.0)).all() or abs(e - e_ref) > 1e-3 * max(1.0, abs(e_ref)):
                out["energy_faults"] += 1
    # A document may repeat a sentence: coverage counts distinct sentences
    # by their score, and either copy covers both.
    out["window_faults"] = len(set(where) - covered) + bad_windows
    return out


def _restriction(where: dict, values: list) -> list | None:
    """Increasing indices of the request's problem whose scores are
    ``values``, as a window lists its sentences in document order; the least
    such at each step (a repeated sentence's copies are interchangeable)."""
    idx, prev = [], -1
    for v in values:
        cands = where.get(v, ())
        i = bisect.bisect_right(cands, prev)
        if i == len(cands):
            return None
        prev = cands[i]
        idx.append(prev)
    return idx


COMPARED = ("bad_answers", "objective_gap", "mu_beta_gap", "formulation_gap",
            "rounding_faults", "energy_faults", "window_faults")
SET_FROM_READINGS = ("objective_gap", "mu_beta_gap", "formulation_gap")


def numbers(judged: list[dict]) -> dict:
    """The sample's numbers: gaps by their largest, faults by their count;
    ``quality_gap`` (not compared) by its mean."""
    if not judged:
        return {k: math.inf for k in COMPARED + ("quality_gap",)}
    out = {"bad_answers": float(sum(j["bad"] for j in judged))}
    for k in ("objective_gap", "mu_beta_gap", "formulation_gap"):
        out[k] = max(j[k] for j in judged)
    for k in ("rounding_faults", "energy_faults", "window_faults"):
        out[k] = float(sum(j[k] for j in judged))
    out["quality_gap"] = sum(j["quality_gap"] for j in judged) / len(judged)
    return out


def limits(limit_file: dict) -> dict:
    return {k: float(limit_file[k]) if k in SET_FROM_READINGS else 0.0 for k in COMPARED}


def verdict(nums: dict, lims: dict) -> bool:
    return all(nums[k] <= lims[k] for k in lims)


def control_answer(sentences, m: int, lam: float, mu_c, beta_c) -> dict:
    """The control's answer: the reference put in the program's place, from
    its lower-precision mu and beta: the best selection under them and its
    objective under them."""
    x = scores.best_selection(mu_c, beta_c, lam, m)
    return {"selection": x.astype(np.int32),
            "selected": [sentences[i] for i in np.nonzero(x)[0]],
            "objective": scores.objective(mu_c, beta_c, lam, x)}
