@python sample_torch.py --model DiT-L --ckpt ..\1880000.pt %*
