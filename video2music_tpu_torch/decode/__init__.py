"""B=1 KV-cached chord decoding of the port."""
