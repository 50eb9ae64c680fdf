"""p_chain_ms: per P picture, the synchronised spans of the fused P chain
(dense mode decision, decision tree, merge snap, encode pass, finish), in
the window's second part; the intra fixup is not included."""

CHAIN = ("p.dense_md_p", "p.decide_tree_dev", "p.merge_snap",
         "p.encode_pass_p_direct", "p._finish_fused")


def read(rec):
    spans = (rec.get("trace") or {}).get("spans", ())
    pictures = sum(1 for n, _ in spans if n == "p.dense_md_p")
    if not pictures:
        return None
    return 1e3 * sum(s for n, s in spans if n in CHAIN) / pictures
