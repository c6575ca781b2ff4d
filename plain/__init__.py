"""Plain references, independent of both packages, that tests hold the port
against."""
