"""Native host codecs (C++ via ctypes): TSV, PLINK .bed and VCF."""
