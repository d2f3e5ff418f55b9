"""B5–B6's least time over their device time in the traced round
(kernels/ssd_scan.py, csrc/ssd_scan.cu): per layer, B5 for each step and
evaluation, B6 for each step, at the cell's shapes and dtype."""


def read(run):
    c, f, t = run.cfg, run.flops, run.trace
    if t is None or c["block"] != "ssd":
        return None
    spent = t.device_seconds(r"ssd_(fwd|bwd)")
    if not spent:
        return None
    Q, dt = c["chunk_size"], c["torch_dtype"]
    dims = dict(nc=f.n_chunks(c["seq_len"], Q), Q=Q,
                H=c["expand"] * c["d_model"] // c["headdim"],
                P=c["headdim"], N=c["d_state"], e_x=f.ELEMENT[dt])
    train, evals = f.ssd_work(c["batch"], **dims), f.ssd_work(c["n_eval"],
                                                             **dims)
    st = run.traced.stats
    need = c["n_layer"] * (
        st.steps_run * (f.bound_s(*train["B5"], dt) + f.bound_s(*train["B6"],
                                                                dt))
        + st.evals_run * f.bound_s(*evals["B5"], dt))
    return 100.0 * need / spent
