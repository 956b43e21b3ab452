"""Matrix primitives: batched top-k selection."""
