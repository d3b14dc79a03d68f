"""The port's CLI implementations (``run``; console script ``vae-train-torch``)."""
