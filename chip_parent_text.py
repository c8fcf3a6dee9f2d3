"""The binary flagship and full-row runs of a checkout's package, on one
NVIDIA GPU: the model text's digest and the holdout AUC of each.

Run from the root of a checkout:

    python3 chip_parent_text.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with ``git archive`` into the
git-ignored ``build/parent``. Each runs in a process of its own that
imports ``lightgbm_tpu_torch`` from ROOT (its kernels build under
ROOT/build) and trains ``chip_smoke.py``'s GOSS flagship (1M rows, 16
rounds) and its full-row run (2M rows, 16 rounds, the row partition off),
on this script's data and parameters. ``ROOT:levels-as-numbers`` runs
ROOT with the quantizer dividing by its level counts as Python numbers,
as the package did before they became device tensors (on CUDA such a
division is a product with the reciprocal): a copy of that quantizer
takes the place of ``boosting.gbdt.quantize``. One line per run: the root,
the run, the sha256 of the model text, the holdout AUC; the card's name
and power limit first. It needs a CUDA device and imports neither JAX nor
``lightgbm_tpu``.
"""
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_one(root, levels_as_numbers):
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    sys.path.insert(0, root)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting import gbdt
    if levels_as_numbers:
        def python_levels(gk_m, hk_m, mask_count, glevels, hlevels, noise):
            # the quantizer as it was, dividing by Python numbers
            gmax = torch.max(torch.abs(gk_m))
            hmax = torch.max(hk_m)
            scale_g = torch.clamp(gmax / int(glevels), min=1e-30)
            scale_h = torch.clamp(hmax / int(hlevels), min=1e-30)
            ng, nh = noise if noise is not None else (0.0, 0.0)
            live = mask_count > 0
            gq = torch.where(live, torch.round(gk_m / scale_g + ng), 0.0)
            hq = torch.where(live, torch.round(hk_m / scale_h + nh), 0.0)
            return gq, hq, torch.stack([scale_g, scale_h,
                                        torch.ones_like(scale_g)])
        gbdt.quantize = python_levels
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(lgt.__file__))) == os.path.abspath(root)
    for name, params, n in (("flagship", cs.PARAMS, cs.N_TRAIN),
                            ("full_row", dict(cs.FULL_PARAMS,
                                              tpu_hist_partition="false"),
                             cs.N_FULL)):
        X, y = cs.synth_higgs(n + cs.N_HOLDOUT, cs.N_FEAT, seed=0)
        ds = lgt.Dataset(X[:n], label=y[:n])
        bst = lgt.Booster(params=dict(params), train_set=ds)
        bst.add_valid(ds.create_valid(X[n:], label=y[n:]), "holdout")
        for _ in range(cs.ROUNDS):
            bst.update()
        torch.cuda.synchronize()
        [(_, _, auc, _)] = bst.eval_valid()
        digest = hashlib.sha256(bst.model_to_string().encode()).hexdigest()
        print(f"{root}{':levels-as-numbers' if levels_as_numbers else ''} "
              f"{name}: model text sha256 {digest[:16]}, holdout AUC "
              f"{auc:.6f}", flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        run_one(argv[1], argv[2] == "1")
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for spec in argv or [HERE]:
        root, _, mode = spec.partition(":")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root),
                        "1" if mode == "levels-as-numbers" else "0"],
                       check=True, cwd=HERE)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
