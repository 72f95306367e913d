"""Model layers, the decoder assembly and weight conversion."""
