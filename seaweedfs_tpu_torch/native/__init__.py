"""Host C routines (CRC32C, GF(256) transform, compact needle map)."""
