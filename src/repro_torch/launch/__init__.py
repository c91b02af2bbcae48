"""Entry points: ``python -m repro_torch.launch.serve`` serves llama3-8b from a
TensorHub replica on the card, ``launch.train`` trains it, and
``launch.networked`` runs a controller and worker processes over sockets."""
