"""B2–B4's least time over their device time in the traced round
(kernels/flash_attention.py, csrc/flash_attention.cu): per layer, a
forward (B2) for each step and evaluation, a backward (B3, B4) for each
step, at the cell's shapes and dtype."""


def read(run):
    c, f, t = run.cfg, run.flops, run.trace
    if t is None or c["block"] != "attention":
        return None
    spent = t.device_seconds(r"fa_(fwd|bwd)")
    if not spent:
        return None
    H, D, dt = c["num_attention_heads"], c["hidden_size"], c["torch_dtype"]
    shape = dict(S=c["seq_len"], Hq=H, Hkv=c["num_key_value_heads"],
                 hd=D // H, e=f.ELEMENT[dt])
    train = f.attention_work(c["batch"], **shape)
    evals = f.attention_work(c["n_eval"], **shape)
    st = run.traced.stats
    need = c["num_hidden_layers"] * (
        st.steps_run * sum(f.bound_s(*train[k], dt) for k in ("B2", "B3",
                                                              "B4"))
        + st.evals_run * f.bound_s(*evals["B2"], dt))
    return 100.0 * need / spent
