"""Random state: seeds to ``torch.Generator``s."""
