"""The benchmark's plain reference: the DiT of Peebles & Xie (arXiv:2212.09748)
as OliBomby/osu-diffusion conditions it, its Gaussian diffusion, the
training loss, AdamW and the EMA, in plain PyTorch.

It imports nothing of the measured program and no JAX. It takes weights as
a state dict under the reference model's parameter names, which the
benchmark makes from the seed and hands to both sides; whatever the program
derives from them (int8 codes, padded buckets, the processed batch with its
flips and offsets, the classifier-free-guidance doubling) is worked out
again here.
"""
