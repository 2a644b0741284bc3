"""Plain references that the benchmark's checks and the tests hold the
port to: straightforward implementations written from the published
description, with no code of the store they check."""
