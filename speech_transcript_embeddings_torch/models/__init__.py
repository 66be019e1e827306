"""Models of the port: conformer audio encoder, text encoder, heads, dual encoder."""
