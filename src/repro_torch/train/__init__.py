"""Train state, the train-step builder and the trainer loop."""
