"""The benchmark's plain reference: SGPN (PointNet++ MSG encoders, the
TripletGCN, the heads), its train step with AdamW and the training
augmentation, and the EfficientNet-B5 image branch, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it reads the weights the benchmark generated from the seed and the
scenes the benchmark generated, and works out every derived quantity (FPS
centroids, ball-query neighbourhoods, slot packing, serving caches,
augmentation draws) again.
"""
