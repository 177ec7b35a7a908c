"""flash_dkv_tile_share.train: the share of the whole causal range's query
tiles that the port's dk/dv kernel (K3, ``flash_bwd_dkv_tc_kernel``)
visits, in percent, over the traced slice: the rise of the port's
``flash_bwd_dkv.query_tiles`` counter over the rise of
``flash_bwd_dkv.causal_query_tiles`` across the slice's ``learner.step``
spans.  On packed rows K3 ends each key block's query range at its keys'
documents, so the share follows the packed pairs; 100 where every row
holds one document.  A port without those counters, or a slice with no
bf16 K3 launch on the options' path, reads nothing."""

from portbench import spans

VISITED = "flash_bwd_dkv.query_tiles"
CAUSAL = "flash_bwd_dkv.causal_query_tiles"


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None:
        return None
    steps = [s for s in got[0] if s["name"] == spans.STEP]
    if not steps or any(c not in s["counters_in"]
                        for s in steps for c in (VISITED, CAUSAL)):
        return None
    rise = {c: sum(s["counters_out"][c] - s["counters_in"][c]
                   for s in steps) for c in (VISITED, CAUSAL)}
    if not rise[CAUSAL]:
        return None
    return 100.0 * rise[VISITED] / rise[CAUSAL]
