from repro_torch.embeddings.encoder import HashedBowEncoder, problem_from_sentences  # noqa: F401
