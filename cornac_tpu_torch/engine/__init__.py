"""Neural building blocks shared by the neural model family."""
