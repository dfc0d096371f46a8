"""Training of the port's text encoder (`semantic_encoder`): the
contrastive loop of `scripts/train_semantic_encoder_v2.py` through
`embeddings/encoder.BertEncoder`, whose attention runs the hand-written
kernels forward and backward on the card."""
