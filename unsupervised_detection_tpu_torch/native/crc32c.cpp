// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of
// TensorFlow's tensor bundles: slicing-by-8 over eight 256-entry tables.
// udt_crc32c(crc, data, n) extends `crc` (0 to start) by n bytes.
#include <cstddef>
#include <cstdint>
#include <cstring>

static uint32_t table[8][256];

static bool init_tables() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
        table[0][i] = c;
    }
    for (int t = 1; t < 8; ++t)
        for (int i = 0; i < 256; ++i)
            table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
    return true;
}

static const bool tables_ready = init_tables();

extern "C" uint32_t udt_crc32c(uint32_t crc, const uint8_t* data, size_t n) {
    uint32_t c = ~crc;
    for (; n >= 8; n -= 8, data += 8) {
        uint32_t lo, hi;  // little-endian words, as the tables assume
        std::memcpy(&lo, data, 4);
        std::memcpy(&hi, data + 4, 4);
        lo ^= c;
        c = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^ table[5][(lo >> 16) & 0xFF] ^
            table[4][lo >> 24] ^ table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
            table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    }
    for (; n; --n, ++data) c = (c >> 8) ^ table[0][(c ^ *data) & 0xFF];
    return ~c;
}
