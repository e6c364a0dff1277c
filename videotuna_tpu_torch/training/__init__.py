"""Training of the port: the trainer and its optimizer, LoRA, callbacks."""
