"""Summarize one document: ``build_request("summarize", sentences=..., m=...,
lam=...)`` of the port, judged by the plain reference
(``h100bench/reference/check.py``) against its answer and against what its
solver was handed (``h100bench/capture.py``)."""

from __future__ import annotations

from types import SimpleNamespace


def build(traffic, k: int):
    """(the request, its sentences) of the mix's k-th request."""
    from repro_torch.workloads import build_request

    _, sentences = traffic.document(k)
    return build_request("summarize", sentences=sentences, m=traffic.m,
                         lam=traffic.lam), sentences


def judge(config: dict, limits_file: dict, seed: int, device, sample: list, lam: float,
          logs: dict) -> SimpleNamespace:
    """The reference's numbers for the sampled answers, and their limits."""
    from h100bench import reference
    from h100bench.reference import check, scores

    embed = reference.embedder(config, seed, device)
    int_range = int(config["solve"]["int_range"])
    judged = []
    for r in sample:
        mu, beta = scores.scores(embed(r.sentences))
        answer = {"selection": r.response.selection, "selected": r.response.selected,
                  "objective": r.response.objective}
        one = check.judge_answer(r.sentences, r.m, lam, mu, beta, answer)
        one.update(check.judge_solver(logs.get(r.rid), mu, beta, int_range))
        judged.append(one)
    nums = check.numbers(judged)
    lims = check.limits(limits_file)
    return SimpleNamespace(numbers=nums, limits=lims, ok=check.verdict(nums, lims),
                           exact=all(j["exact_bounds"] for j in judged), judged=judged)


def notes(config: dict, requests: list) -> list[str]:
    """Progress lines: the sentences the encoder's context cut off."""
    enc = config.get("encoder")
    total = sum(len(r.sentences) for r in requests)
    cut = docs = 0
    if enc is not None:
        from h100bench.reference.encoder import pack_sentences

        for r in requests:
            _, segs = pack_sentences(r.sentences, enc["max_len"])
            lost = len(r.sentences) - len(set(segs[segs >= 0].tolist()))
            cut, docs = cut + lost, docs + (lost > 0)
    return [f"context: {cut} of {total} sentences cut off by the encoder's context, in "
            f"{docs} of {len(requests)} documents"]
