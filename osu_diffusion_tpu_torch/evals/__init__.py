"""Evaluation and analysis harness (port of osu_diffusion_tpu/evals/).

Ports of the reference `testing/` scripts; each module runs as
`python -m osu_diffusion_tpu_torch.evals.<module>`, on the card unless
`--device cpu` is given:
- toy.py       — in-paint accuracy over the toy suites (test_toy.py)
- unfuck.py    — pattern-repair robustness (unfuck_pattern.py)
- distances.py — spacing-fidelity MSE/MAE (distance_distance.py)
- embeddings.py— t-SNE / SVM / nearest-neighbour style analytics
                 (plot_embeddings.py, embedding_svm.py, find_similar_beatmaps.py,
                  find_unique_beatmaps.py, print_ckpt.py)
- tooling.py   — dataset metadata tooling (create_beatmap_idx.py,
                 create_beatmap_dataframe.py, validate_beatmap_dataframe.py)
- plot_loss.py — log.txt loss-curve overlay (plot_loss.py)

scipy, sklearn, pandas and matplotlib are imported inside the functions
that need them, so importing a module never needs them.
"""
