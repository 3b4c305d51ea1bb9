"""The benchmark's yardstick: input generators, the kNN search and weight
formula, and plain solvers that the program's answers are judged against.

Nothing here imports the program (``graphlearning_tpu_torch``), JAX or the
JAX package.  Each frozen copy names the file and lines it was copied from.
"""
