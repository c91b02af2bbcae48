"""Entry points: ``python -m repro_torch.launch.serve`` serves llama3-8b from a
TensorHub replica on the card."""
