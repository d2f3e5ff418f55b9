"""Model FLOPs of every training step and evaluation of the window over
the window's seconds times the card's dense peak in the configuration's
dtype (hippo_bench.flops: bf16 on the tensor cores, float32 on the CUDA
cores)."""


def read(run):
    c, f = run.cfg, run.flops
    work = sum(r.stats.steps_run * f.train_flops(c, c["batch"], c["seq_len"])
               + r.stats.evals_run * f.eval_flops(c, c["n_eval"],
                                                  c["seq_len"])
               for r in run.rounds)
    return 100.0 * work / (run.window_s * f.FLOP_PER_S[c["torch_dtype"]])
