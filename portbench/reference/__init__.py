"""Plain float32 PyTorch reference of the benchmark's models: a Mistral
decoder's forward, its loss and AdamW. It imports nothing of the port and
reads only what the benchmark drew: the initial weights (named as
``portbench.weights`` names them) and the batches."""
