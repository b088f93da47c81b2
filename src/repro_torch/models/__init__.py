"""The dense LM of the training slice: config, param specs, layers, model."""
