"""The reference tool's output header (``putImageToFile``, ``ppmx-edward.c:239-261``)."""

COMMENT = b"# generated by ppmx_edward\n"


def p6(width: int, height: int, max_color: int) -> bytes:
    """The header of a P6 file of ``width`` x ``height`` pixels."""
    return b"P6\n" + COMMENT + b"%d %d\n%d\n" % (width, height, max_color)
