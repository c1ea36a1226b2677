"""nccl_ms.per_call.rows4: the NCCL kernels' profiler ms a call on the rank
that waits least (the least over the ranks, as ``device_profile``'s
``collective_ms``): a collective's kernel runs until every rank has
joined, so the least rank's is nearest to the transfer itself.  For a
cell on several cards (``traffic/b4_inflight2_rows4_card.json``)."""


def read(ctx):
    per = [s["nccl_s"] * 1e3 / s["calls"] for s in ctx.ranks
           if s["calls"] and s["nccl_s"] > 0]
    return min(per) if len(per) == len(ctx.ranks) else None
