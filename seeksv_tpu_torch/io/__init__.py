from .bam import BamRecords, read_bam, read_sam_text, CIGAR_CHARS, SEQ_NT16
from .fasta import read_fasta, read_fai
