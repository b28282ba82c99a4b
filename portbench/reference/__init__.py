"""The plain reference of the benchmark: the SM3 stage-1 training step in
plain PyTorch (float32, TF32 off), independent of the program under test.

Nothing here imports the program or the JAX package. What the program
derives from the benchmark's inputs (the epoch order, the step seeds, the
augmented views) is worked out again here from frozen copies of the
formulas (`prng`, `augment`); the models (`resnet`, `vit`, `ssl`) and the
loss follow the published descriptions with the port's module names, so
that one seeded set of weights, made by the benchmark, loads into both.
"""
