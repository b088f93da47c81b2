"""The plain reference: the model families, the SparCML sync and AdamW
under ZeRO-1, in plain PyTorch and float32, written from the published
equations and the port's documented layout. It imports neither the port
nor JAX, and takes from the benchmark only the configuration's numbers
and the inputs (weights, tokens, rounding bits) the benchmark made.

``train.run`` follows the first steps of a cell; ``Prec(fp8=True)`` is
the control (every linear layer's operands rounded to fp8, the precision
below the configuration's bf16)."""
